"""The seeded inputs, the decimal text, the wire encoding, the import feed and
the closed loops."""

import json

import numpy as np
import pytest

from wbench import gen, load, wire

DATA = {"dim": 16, "clusters": 8, "center_scale": 2.0, "spread": 0.35, "query_noise": 0.1,
        "normalize": True}


@pytest.mark.parametrize("seed", [0, 7, 3_000_000_123, -5])
def test_dataset_is_a_function_of_the_seed(seed):
    x1, q1 = gen.dataset(DATA, seed, 500, 32)
    x2, q2 = gen.dataset(DATA, seed, 500, 32)
    assert x1.dtype == np.float32 and x1.shape == (500, 16) and q1.shape == (32, 16)
    assert np.array_equal(x1, x2) and np.array_equal(q1, q2)
    np.testing.assert_allclose(np.linalg.norm(x1, axis=1), 1.0, rtol=1e-5)
    x3, _ = gen.dataset(DATA, seed + 1, 500, 32)
    assert not np.array_equal(x1, x3)


def test_rows_do_not_depend_on_the_number_of_queries():
    assert np.array_equal(gen.dataset(DATA, 3, 300, 0)[0], gen.dataset(DATA, 3, 300, 50)[0])


def test_import_batches_are_seeded_and_distinct():
    a = gen.import_batch(DATA, 11, 4, 100)
    assert np.array_equal(a, gen.import_batch(DATA, 11, 4, 100))
    assert not np.array_equal(a, gen.import_batch(DATA, 11, 5, 100))


def test_decimal_text_parses_to_the_values_it_reports():
    v = np.random.default_rng(1).standard_normal((5, 33)).astype(np.float32)
    v[0, 0], v[0, 1] = -9.9999994, 0.0
    texts, exact = gen.decimal_rows(v)
    for t, want in zip(texts, exact):
        got = np.asarray(json.loads(b"[" + t + b"]"), dtype=np.float32)
        assert np.array_equal(got, want)
    assert np.abs(exact - v).max() <= 0.5e-7 + 1e-6
    with pytest.raises(ValueError):
        gen.decimal_rows(np.array([[10.0]], np.float32))


def test_object_uuids_round_trip():
    for i in (0, 1, 289_999, 10 ** 9):
        assert gen.uuid_index(gen.object_uuid(i)) == i
    assert gen.uuid_index("not-a-uuid") == -1


def test_batch_search_request_is_the_proto_encoding():
    from google.protobuf import descriptor_pb2, descriptor_pool
    from google.protobuf.message_factory import GetMessageClass

    f = descriptor_pb2.FileDescriptorProto(name="t.proto", package="t", syntax="proto3")
    T = descriptor_pb2.FieldDescriptorProto
    nv = f.message_type.add(name="NV")
    nv.field.add(name="vector", number=1, type=T.TYPE_FLOAT, label=T.LABEL_REPEATED)
    sr = f.message_type.add(name="SR")
    sr.field.add(name="class_name", number=1, type=T.TYPE_STRING, label=T.LABEL_OPTIONAL)
    sr.field.add(name="limit", number=2, type=T.TYPE_UINT32, label=T.LABEL_OPTIONAL)
    sr.field.add(name="near_vector", number=6, type=T.TYPE_MESSAGE, label=T.LABEL_OPTIONAL,
                 type_name=".t.NV")
    b = f.message_type.add(name="B")
    b.field.add(name="requests", number=1, type=T.TYPE_MESSAGE, label=T.LABEL_REPEATED,
                type_name=".t.SR")
    pool = descriptor_pool.DescriptorPool()
    pool.Add(f)
    B = GetMessageClass(pool.FindMessageTypeByName("t.B"))
    q = np.random.default_rng(2).standard_normal((3, 200)).astype(np.float32)
    msg = B.FromString(wire.batch_search_request("Cls", q, 10))
    assert len(msg.requests) == 3
    for r, row in zip(msg.requests, q):
        assert r.class_name == "Cls" and r.limit == 10
        assert np.array_equal(np.asarray(r.near_vector.vector, np.float32), row)


def test_reply_parser_reads_ids_and_distances():
    def field(tag, payload):
        return bytes([tag]) + wire.varint(len(payload)) + payload
    import struct
    result = field(0x0A, b"abc") + b"\x19" + struct.pack("<d", 0.25)
    reply = field(0x0A, result) + field(0x0A, result)
    raw = field(0x0A, reply) + field(0x0A, field(0x1A, b"oops"))
    parsed = wire.parse_batch_reply(raw)
    assert [x.id for x in parsed.replies[0].results] == ["abc", "abc"]
    assert parsed.replies[0].results[1].distance == 0.25
    assert parsed.replies[1].error_message == "oops"


def test_reservoir_keeps_a_seeded_sample():
    def draw(seed):
        r = load.Reservoir(5, seed)
        for i in range(100):
            s = r.slot()
            if s is not None:
                r.put(s, i)
        return r.items
    assert draw(3) == draw(3) and len(draw(3)) == 5 and draw(3) != draw(4)


def test_the_import_feed_sends_the_seeds_bodies_in_order_and_ends():
    feed = load.ImportFeed({"data": DATA, "seed": 2 ** 31 + 5, "class": "C", "per": 7,
                            "first": 3})
    try:
        got = [feed.next() for _ in range(4)]
    finally:
        feed.close()
    assert feed.proc.poll() is not None
    c = gen.centers(DATA, 2 ** 31 + 5)
    for j, (b, body, rows) in enumerate(got):
        assert b == 3 + j and rows == 7
        assert body == gen.import_body(DATA, 2 ** 31 + 5, "C", b, 7, c)
        objs = json.loads(body)["objects"]
        assert [o["id"] for o in objs] == [gen.object_uuid(b * 7 + i) for i in range(7)]
        want = gen.decimal_rows(gen.import_batch(DATA, 2 ** 31 + 5, b, 7))[1]
        assert np.array_equal(np.asarray([o["vector"] for o in objs], np.float32), want)


def _slow_server(reply, delay):
    import http.server
    import threading
    import time

    class Slow(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            time.sleep(delay)
            out = reply(body)
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Slow)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_the_import_loop_times_the_whole_window_and_judges_after_it():
    """Two callers against a server that takes 20 ms or more a batch and refuses
    every third: the window's requests are all recorded, a refused batch is
    failed and not acknowledged, and the callers spend almost none of the
    window between a reply and their next request."""
    def reply(body):
        objs = json.loads(body)["objects"]
        status = "FAILED" if int(objs[0]["id"][-4:], 16) % 3 == 0 else "SUCCESS"
        return json.dumps([{"id": o["id"], "result": {"status": status}}
                           for o in objs]).encode()

    srv = _slow_server(reply, 0.02)
    nxt = iter(range(10 ** 6))

    def next_body():
        b = next(nxt)
        objs = [{"id": gen.object_uuid(b * 2 + i)} for i in range(2)]
        return b, json.dumps({"objects": objs}).encode(), 2

    acked = {}
    try:
        win = load.batch_import(srv.server_address[1], next_body, 2, 0.5, acked)
    finally:
        srv.shutdown()
    assert 8 <= len(win.reqs) <= 52
    assert all(r.raw == b"" for r in win.reqs)
    for r in win.reqs:
        refused = int(gen.object_uuid(r.key * 2)[-4:], 16) % 3 == 0
        assert r.ok is not refused and (r.key in acked) is not refused
    assert sum(acked.values()) == 2 * sum(r.ok for r in win.reqs)
    assert load.client_share(win) < 0.1


def test_client_share_is_the_time_between_a_reply_and_the_next_request():
    win = load.Window(start=0.0, end=1.0)
    win.reqs = [load.Req(key=0, rows=1, due=0.0, sent=0.0, done=0.3, caller=0),
                load.Req(key=1, rows=1, due=0.4, sent=0.4, done=0.9, caller=0),
                load.Req(key=2, rows=1, due=0.0, sent=0.0, done=1.0, caller=1)]
    assert load.client_share(win) == pytest.approx(0.05)
