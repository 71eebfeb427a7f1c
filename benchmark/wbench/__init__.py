"""The yardstick of the benchmark of `weaviate_tpu_torch`.

`benchmark/run.py` drives one cell of `BENCHMARK.json`: it starts the
port's server as a child process (`benchmark/launcher.py`), offers the
cell's traffic from this process as a client would, and judges what the
clients received against the plain reference (`reference.py`), which
imports nothing of the port.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own that `spec.py` finds by name: `configs/<config>.json`,
`traffic/<mix>.json`, `metrics/<metric>.py`.
"""
