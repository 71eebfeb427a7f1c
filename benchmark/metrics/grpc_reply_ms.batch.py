"""grpc_reply_ms.batch: the p50, over the window's gRPC BatchSearch
traces, of the `grpc.reply` span: the reply's native marshalling
(`reply_native.build_batch_reply_packed` on the raw lane)."""

from wbench import spantree


def read(run):
    return spantree.per_request_p50(run, spantree.BATCH, ["grpc.reply"])
