"""import_device_add_ms.import: the p50, over the window's REST batch
imports, of the `index.device_write` span: the device store's growth, the
rows' write, the slot assignment and the snapshot's publish."""

from wbench import spantree


def read(run):
    return spantree.per_request_p50(run, spantree.IMPORT, ["index.device_write"])
