"""import_store_ms.import: the p50, over the window's REST batch imports,
of the batch's storage writes: the LSM put of the objects and doc ids with
their WAL (`lsm.put`), the inverted index (`inverted.add`) and the vector
log (`index.vector_log`), summed."""

from wbench import spantree


def read(run):
    return spantree.per_request_p50(run, spantree.IMPORT,
                                    ["lsm.put", "inverted.add", "index.vector_log"])
