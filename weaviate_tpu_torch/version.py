# The port's copy of weaviate_tpu/version.py, its imports pointed at the port.
"""Version of the weaviate_tpu framework.

Mirrors the reference version surface (openapi-specs/schema.json:1637 —
"1.19.0-beta.1") with our own build identity.
"""

__version__ = "1.19.0-tpu.1"
