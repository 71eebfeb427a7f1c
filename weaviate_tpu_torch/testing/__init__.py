"""In-process test and chaos instrumentation that ships with the port
(copies of `weaviate_tpu/testing/`): the fault-injection harness
(`faults`) and the runtime sanitizers (`sanitizers`). Import submodules
directly (``from weaviate_tpu_torch.testing import faults``)."""
