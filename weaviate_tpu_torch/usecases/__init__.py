# The port's copy of weaviate_tpu/usecases/__init__.py, its imports pointed at the port.
"""Use-case (business-logic) layer.

Reference: usecases/ — objects.Manager/BatchManager, traverser.Traverser/
Explorer, hybrid fusion, classification, backup, nodes.
"""
