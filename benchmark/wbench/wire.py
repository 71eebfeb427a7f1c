"""The client's side of the port's gRPC wire (`weaviatetpu.v1.Weaviate`):
BatchSearch requests encoded by hand from the query rows, and replies
parsed by protobuf's C parser through message classes built here from the
fields a client reads (an id and a distance a result)."""

from __future__ import annotations

import numpy as np

BATCH_SEARCH = "/weaviatetpu.v1.Weaviate/BatchSearch"
MAX_MESSAGE_BYTES = 1 << 30
CHANNEL_OPTIONS = [("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                   ("grpc.max_send_message_length", MAX_MESSAGE_BYTES)]


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(tag: int, payload: bytes) -> bytes:
    return bytes([tag]) + varint(len(payload)) + payload


def batch_search_request(class_name: str, q: np.ndarray, k: int) -> bytes:
    """BatchSearchRequest{requests: [SearchRequest{class_name, limit k,
    near_vector{vector: row}}]} for each row of q."""
    head = _field(0x0A, class_name.encode()) + b"\x10" + varint(int(k))
    rows = np.ascontiguousarray(q, dtype="<f4")
    return b"".join(_field(0x0A, head + _field(0x32, _field(0x0A, row.tobytes())))
                    for row in rows)


def _reply_classes():
    from google.protobuf import descriptor_pb2, descriptor_pool

    f = descriptor_pb2.FileDescriptorProto(name="wbench_reply.proto", package="wbench",
                                           syntax="proto3")
    T = descriptor_pb2.FieldDescriptorProto

    def msg(name, fields):
        m = f.message_type.add(name=name)
        for fname, num, ftype, label, tname in fields:
            fd = m.field.add(name=fname, number=num, type=ftype, label=label)
            if tname:
                fd.type_name = tname
    opt, rep = T.LABEL_OPTIONAL, T.LABEL_REPEATED
    msg("SearchResult", [("id", 1, T.TYPE_STRING, opt, None),
                         ("distance", 3, T.TYPE_DOUBLE, opt, None)])
    msg("SearchReply", [("results", 1, T.TYPE_MESSAGE, rep, ".wbench.SearchResult"),
                        ("error_message", 3, T.TYPE_STRING, opt, None)])
    msg("BatchSearchReply", [("replies", 1, T.TYPE_MESSAGE, rep, ".wbench.SearchReply")])
    pool = descriptor_pool.DescriptorPool()
    pool.Add(f)
    desc = pool.FindMessageTypeByName("wbench.BatchSearchReply")
    try:
        from google.protobuf.message_factory import GetMessageClass
        return GetMessageClass(desc)
    except ImportError:  # protobuf before 4.22
        from google.protobuf import message_factory
        return message_factory.MessageFactory(pool).GetPrototype(desc)


_BATCH_REPLY = None


def parse_batch_reply(raw: bytes):
    """-> the parsed BatchSearchReply (.replies[i].results[j].id/.distance,
    .replies[i].error_message)."""
    global _BATCH_REPLY
    if _BATCH_REPLY is None:
        _BATCH_REPLY = _reply_classes()
    return _BATCH_REPLY.FromString(raw)
