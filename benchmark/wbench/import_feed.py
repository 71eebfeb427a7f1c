"""The import cell's feed: a child process that makes the POST
/v1/batch/objects bodies of batches `first`, `first` + 1, ... from the
seed (`gen.import_body`) and writes each to its standard output, an
8-byte batch number and an 8-byte length first, ahead of the caller that
sends them. It ends when the reader closes the pipe.

    python benchmark/wbench/import_feed.py '{"data": {...}, "seed": 1,
        "class": "C", "per": 100, "first": 0}'
"""

from __future__ import annotations

import json
import os
import struct
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wbench import gen  # noqa: E402


def main() -> int:
    spec = json.loads(sys.argv[1])
    data, seed = spec["data"], int(spec["seed"])
    c = gen.centers(data, seed)
    out = sys.stdout.buffer
    b = int(spec.get("first", 0))
    try:
        while True:
            body = gen.import_body(data, seed, spec["class"], b, int(spec["per"]), c)
            out.write(struct.pack("<qQ", b, len(body)) + body)
            out.flush()
            b += 1
    except (BrokenPipeError, KeyboardInterrupt):
        return 0


if __name__ == "__main__":
    sys.exit(main())
