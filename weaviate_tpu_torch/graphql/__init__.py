# The port's copy of weaviate_tpu/graphql/__init__.py, its imports pointed at the port.
"""GraphQL engine: query parser + executor for Get / Aggregate / Explore.

Reference: adapters/handlers/graphql — the reference builds a graphql-go
schema dynamically from the data schema (local/get/class_builder_fields.go)
and lets the library execute. graphql-core is not available in this image, so
this package implements the query-language subset Weaviate's GraphQL surface
actually uses: operations, arguments (including enum/object/list literals),
variables, aliases, and inline fragments (for cross-references); executed
directly against the traverser/aggregator.
"""

from weaviate_tpu_torch.graphql.executor import GraphQLExecutor
from weaviate_tpu_torch.graphql.parser import GraphQLParseError, parse_query

__all__ = ["GraphQLExecutor", "parse_query", "GraphQLParseError"]
