"""import_decode_ms.import: the p50, over the window's REST batch imports,
of the `rest.decode` span: `json.loads` of the request's body."""

from wbench import spantree


def read(run):
    return spantree.per_request_p50(run, spantree.IMPORT, ["rest.decode"])
