# The port's copy of weaviate_tpu/graphql/introspection.py, its imports pointed at the port.
"""GraphQL introspection: a type system generated from the data schema.

Reference: adapters/handlers/graphql/ rebuilds the GraphQL schema from the
data schema on every schema change (makeUpdateSchemaCall); clients rely on
`__schema` / `__type` introspection for autocompletion and codegen. Here the
introspection document is generated on demand from the live SchemaManager —
always current, no rebuild bookkeeping.

Shape: Query { Get: GetObjectsObj, Aggregate: AggregateObjectsObj,
Explore: [ExploreObj] }, one object type per class with a field per property
(scalars mapped per entities/schema data types, cross-references as lists of
the target type) plus the _additional object.
"""

from __future__ import annotations

from typing import Optional

_SCALAR_MAP = {
    "text": "String",
    "string": "String",
    "int": "Int",
    "number": "Float",
    "boolean": "Boolean",
    "date": "String",
    "uuid": "String",
    "blob": "String",
    "phoneNumber": "String",
    "geoCoordinates": "GeoCoordinates",
}


def _t(name: str, kind: str = "OBJECT") -> dict:
    return {"kind": kind, "name": name, "ofType": None}


def _list_of(inner: dict) -> dict:
    return {"kind": "LIST", "name": None, "ofType": inner}


def _field(name: str, ftype: dict, description: str = "") -> dict:
    return {
        "name": name,
        "description": description,
        "args": [],
        "type": ftype,
        "isDeprecated": False,
        "deprecationReason": None,
    }


def _obj_type(name: str, fields: list[dict], description: str = "") -> dict:
    return {
        "kind": "OBJECT",
        "name": name,
        "description": description,
        "fields": fields,
        "inputFields": None,
        "interfaces": [],
        "enumValues": None,
        "possibleTypes": None,
    }


def _scalar(name: str) -> dict:
    return {
        "kind": "SCALAR",
        "name": name,
        "description": "",
        "fields": None,
        "inputFields": None,
        "interfaces": [],
        "enumValues": None,
        "possibleTypes": None,
    }


def _prop_type(prop) -> dict:
    dt = prop.data_type[0] if prop.data_type else "text"
    if dt.endswith("[]"):
        base = _SCALAR_MAP.get(dt[:-2], "String")
        return _list_of(_t(base, "SCALAR"))
    if dt in _SCALAR_MAP:
        base = _SCALAR_MAP[dt]
        return _t(base, "SCALAR" if base != "GeoCoordinates" else "OBJECT")
    # cross-reference: list of the target class type
    return _list_of(_t(dt, "OBJECT"))


def build_introspection(schema) -> dict:
    """-> the __schema payload for the current data schema."""
    classes = sorted(schema.get_schema().classes.values(), key=lambda c: c.name)

    additional_fields = [
        _field("id", _t("String", "SCALAR")),
        _field("vector", _list_of(_t("Float", "SCALAR"))),
        _field("certainty", _t("Float", "SCALAR")),
        _field("distance", _t("Float", "SCALAR")),
        _field("score", _t("Float", "SCALAR")),
        _field("explainScore", _t("String", "SCALAR")),
        _field("creationTimeUnix", _t("String", "SCALAR")),
        _field("lastUpdateTimeUnix", _t("String", "SCALAR")),
        # module-provided explanation props (class_builder_fields.go:590-620)
        _field("featureProjection", _t("FeatureProjection")),
        _field("nearestNeighbors", _t("NearestNeighbors")),
        _field("semanticPath", _t("SemanticPath")),
        _field("interpretation", _t("Interpretation")),
    ]

    types: list[dict] = [
        _scalar("String"), _scalar("Int"), _scalar("Float"), _scalar("Boolean"),
        _obj_type("GeoCoordinates", [
            _field("latitude", _t("Float", "SCALAR")),
            _field("longitude", _t("Float", "SCALAR")),
        ]),
        _obj_type("AdditionalProps", additional_fields,
                  "_additional result metadata"),
        _obj_type("FeatureProjection", [
            _field("vector", _list_of(_t("Float", "SCALAR"))),
        ]),
        _obj_type("NearestNeighbors", [
            _field("neighbors", _list_of(_t("NearestNeighbor"))),
        ]),
        _obj_type("NearestNeighbor", [
            _field("concept", _t("String", "SCALAR")),
            _field("distance", _t("Float", "SCALAR")),
            _field("vector", _list_of(_t("Float", "SCALAR"))),
        ]),
        _obj_type("SemanticPath", [
            _field("path", _list_of(_t("SemanticPathElement"))),
        ]),
        _obj_type("SemanticPathElement", [
            _field("concept", _t("String", "SCALAR")),
            _field("distanceToNext", _t("Float", "SCALAR")),
            _field("distanceToPrevious", _t("Float", "SCALAR")),
            _field("distanceToQuery", _t("Float", "SCALAR")),
            _field("distanceToResult", _t("Float", "SCALAR")),
        ]),
        _obj_type("Interpretation", [
            _field("source", _list_of(_t("InterpretationSource"))),
        ]),
        _obj_type("InterpretationSource", [
            _field("concept", _t("String", "SCALAR")),
            _field("occurrence", _t("Int", "SCALAR")),
            _field("weight", _t("Float", "SCALAR")),
        ]),
    ]

    get_fields, agg_fields = [], []
    for cd in classes:
        fields = [
            _field(p.name, _prop_type(p), p.description or "")
            for p in cd.properties
        ]
        fields.append(_field("_additional", _t("AdditionalProps")))
        types.append(_obj_type(cd.name, fields, cd.description or ""))
        get_fields.append(_field(cd.name, _list_of(_t(cd.name))))
        agg_fields.append(_field(cd.name, _list_of(_t(f"Aggregate{cd.name}Obj"))))
        types.append(_obj_type(
            f"Aggregate{cd.name}Obj",
            [_field("meta", _t("AggregateMetaObj")),
             _field("groupedBy", _t("AggregateGroupedByObj"))],
        ))

    types.append(_obj_type("AggregateMetaObj", [_field("count", _t("Int", "SCALAR"))]))
    types.append(_obj_type("AggregateGroupedByObj", [
        _field("path", _list_of(_t("String", "SCALAR"))),
        _field("value", _t("String", "SCALAR")),
    ]))
    types.append(_obj_type("ExploreObj", [
        _field("className", _t("String", "SCALAR")),
        _field("beacon", _t("String", "SCALAR")),
        _field("certainty", _t("Float", "SCALAR")),
        _field("distance", _t("Float", "SCALAR")),
    ]))
    types.append(_obj_type(
        "GetObjectsObj", get_fields or [_field("_empty", _t("String", "SCALAR"))]
    ))
    types.append(_obj_type(
        "AggregateObjectsObj", agg_fields or [_field("_empty", _t("String", "SCALAR"))]
    ))
    types.append(_obj_type("WeaviateQuery", [
        _field("Get", _t("GetObjectsObj"), "Get objects"),
        _field("Aggregate", _t("AggregateObjectsObj"), "Aggregate objects"),
        _field("Explore", _list_of(_t("ExploreObj")), "Cross-class vector search"),
    ]))

    return {
        "queryType": {"name": "WeaviateQuery"},
        "mutationType": None,
        "subscriptionType": None,
        "types": types,
        "directives": [],
    }


def find_type(schema, name: str) -> Optional[dict]:
    """__type(name:) resolution."""
    for t in build_introspection(schema)["types"]:
        if t["name"] == name:
            return t
    return None


def project_tree(node, selections) -> object:
    """Project an introspection data tree through the query's selection set
    (generic: the data is plain dicts/lists; unknown fields resolve null)."""
    from weaviate_tpu_torch.graphql.parser import Field

    if node is None:
        return None
    if isinstance(node, list):
        return [project_tree(n, selections) for n in node]
    if not selections:
        return node
    if not isinstance(node, dict):
        return node
    out = {}
    for sel in selections:
        if not isinstance(sel, Field):
            continue
        out[sel.out_name] = project_tree(node.get(sel.name), sel.selections)
    return out
