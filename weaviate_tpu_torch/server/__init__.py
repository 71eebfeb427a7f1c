# The port's copy of weaviate_tpu/server/__init__.py, its imports pointed at the port.
from weaviate_tpu_torch.server.app import App
from weaviate_tpu_torch.server.rest import RestServer

__all__ = ["App", "RestServer"]
