# The port's copy of weaviate_tpu/schema/manager.py, its imports pointed at the port.
"""Schema manager: class/property DDL, validation, persistence, migration.

Reference: usecases/schema/manager.go — class/property CRUD validated against
the vector-index config parser injected at configure_api.go:228-231; DDL is
propagated cluster-wide via 2-phase transactions (transactions.go:26-32:
add_class / add_property / delete_class / update_class / read_schema);
persisted to BoltDB (adapters/repos/schema/repo.go); drives migrate.Migrator
to create/drop indexes. Persistence here is an atomically-replaced JSON file;
the tx broadcast seam (`tx`) is filled by cluster.TxManager in multi-node
deployments and is None single-node.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Optional

from weaviate_tpu_torch.cluster.sharding import ShardingConfig, ShardingState
from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.entities.schema import (
    ClassDef,
    Property,
    Schema,
    SchemaError,
    validate_class_name,
    validate_property_name,
)

# transaction types (usecases/schema/transactions.go:26-32)
TX_ADD_CLASS = "add_class"
TX_ADD_PROPERTY = "add_property"
TX_DELETE_CLASS = "delete_class"
TX_UPDATE_CLASS = "update_class"
TX_READ_SCHEMA = "read_schema"

RESERVED_PROPERTY_NAMES = {"id", "_id", "_additional", "vector"}


class SchemaValidationError(SchemaError):
    pass


class SchemaManager:
    def __init__(
        self,
        persist_path: str,
        migrator=None,
        node_names: Optional[list[str]] = None,
        tx=None,
        default_vectorizer: str = "none",
        node_source=None,
    ):
        """`migrator` is the DB (db.DB implements the migrate surface:
        add_class/drop_class/update_class/update_vector_config).
        `node_source` (callable -> list[str]) supplies LIVE membership for
        new classes (gossip auto-discovery); the chosen assignment is
        persisted into shardingConfig so restarts and late joiners keep the
        exact ring regardless of current membership."""
        self.persist_path = persist_path
        self.migrator = migrator
        self.node_names = node_names or ["node-0"]
        self.node_source = node_source
        self.tx = tx  # cluster.TxManager or None (single node)
        self.scaler = None  # usecases/scaler hook, set by cluster wiring
        self.default_vectorizer = default_vectorizer
        # set by App: name -> bool, is this vectorizer an enabled module?
        self.vectorizer_validator = None
        self.schema = Schema()
        self.sharding_states: dict[str, ShardingState] = {}
        self._callbacks: list[Callable[[Schema], None]] = []
        self._lock = threading.RLock()
        os.makedirs(os.path.dirname(persist_path) or ".", exist_ok=True)
        self._load()

    # -- persistence (adapters/repos/schema/repo.go) -------------------------

    def _load(self) -> None:
        if not os.path.exists(self.persist_path):
            return
        with open(self.persist_path) as f:
            data = json.load(f)
        self.schema = Schema.from_dict(data)
        for cd in self.schema.classes.values():
            self._mk_sharding_state(cd)
            if self.migrator is not None:
                self.migrator.add_class(
                    cd, self._parse_vi_config(cd), self.sharding_states[cd.name]
                )

    def _save(self) -> None:
        tmp = self.persist_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.schema.to_dict(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.persist_path)

    def register_schema_update_callback(self, cb: Callable[[Schema], None]) -> None:
        """GraphQL-rebuild seam (configure_api.go:289
        RegisterSchemaUpdateCallback)."""
        self._callbacks.append(cb)

    def _notify(self) -> None:
        for cb in self._callbacks:
            cb(self.schema)

    # -- helpers -------------------------------------------------------------

    def _parse_vi_config(self, cd: ClassDef) -> vi.HnswUserConfig:
        try:
            return vi.parse_and_validate_config(cd.vector_index_type, cd.vector_index_config)
        except vi.ConfigValidationError as e:
            raise SchemaValidationError(str(e)) from e

    def _current_nodes(self) -> list[str]:
        if self.node_source is not None:
            live = sorted(self.node_source())
            if live:
                return live
        return self.node_names

    def _mk_sharding_state(self, cd: ClassDef) -> ShardingState:
        # a previously chosen node assignment (persisted, or shipped in the
        # 2PC payload by the coordinator) is authoritative — every node must
        # build the SAME ring even if its current membership view differs.
        # Legacy classes without one fall back to the STATIC node list, never
        # live membership: _load() runs before gossip has converged, and a
        # half-empty view would silently re-ring existing data
        names = (cd.sharding_config or {}).get("nodes") or self.node_names
        cfg = ShardingConfig.from_dict(cd.sharding_config, len(names))
        repl = (cd.replication_config or {}).get("factor")
        if repl:
            cfg.replicas = int(repl)
        st = ShardingState(cd.name, cfg, names)
        self.sharding_states[cd.name] = st
        cd.sharding_config = {**cfg.to_dict(), "nodes": list(names)}
        return st

    def get_schema(self) -> Schema:
        return self.schema

    def get_class(self, name: str) -> Optional[ClassDef]:
        return self.schema.get(name)

    def resolve_class_name(self, name: str) -> Optional[str]:
        """Case-tolerant class lookup (the REST API capitalizes)."""
        if self.schema.get(name) is not None:
            return name
        cap = name[:1].upper() + name[1:]
        if self.schema.get(cap) is not None:
            return cap
        return None

    def sharding_state(self, class_name: str) -> Optional[ShardingState]:
        return self.sharding_states.get(class_name)

    # -- DDL (usecases/schema/add.go, delete.go, update.go) ------------------

    def add_class(self, class_def: ClassDef | dict) -> ClassDef:
        if isinstance(class_def, dict):
            class_def = ClassDef.from_dict(class_def)
        with self._lock:
            name = validate_class_name(class_def.name)
            class_def.name = name
            if self.schema.get(name) is not None:
                raise SchemaValidationError(f"class {name!r} already exists")
            if not class_def.vectorizer:
                class_def.vectorizer = self.default_vectorizer
            if (
                class_def.vectorizer
                and class_def.vectorizer != "none"
                and self.vectorizer_validator is not None
                and not self.vectorizer_validator(class_def.vectorizer)
            ):
                raise SchemaValidationError(
                    f"vectorizer {class_def.vectorizer!r} is not an enabled "
                    "module (check ENABLE_MODULES)"
                )
            for p in class_def.properties:
                self._validate_property(class_def, p, check_dup=False)
            seen = set()
            for p in class_def.properties:
                low = p.name.lower()
                if low in seen:
                    raise SchemaValidationError(f"duplicate property {p.name!r}")
                seen.add(low)
            vi_cfg = self._parse_vi_config(class_def)  # validates
            # the COORDINATOR fixes the node assignment and ships it in the
            # 2PC payload (and persists it) — remote views must not re-derive
            # the ring from possibly-divergent membership
            if not (class_def.sharding_config or {}).get("nodes"):
                class_def.sharding_config = {
                    **(class_def.sharding_config or {}),
                    "nodes": self._current_nodes(),
                }
            if self.tx is not None:
                self.tx.broadcast_commit(TX_ADD_CLASS, {"class": class_def.to_dict()})
            self.apply_add_class(class_def, vi_cfg)
            return class_def

    def apply_add_class(self, class_def: ClassDef, vi_cfg=None) -> None:
        """Commit phase (local apply; also the remote-node entry point)."""
        with self._lock:
            if vi_cfg is None:
                vi_cfg = self._parse_vi_config(class_def)
            self.schema.classes[class_def.name] = class_def
            state = self._mk_sharding_state(class_def)
            if self.migrator is not None:
                self.migrator.add_class(class_def, vi_cfg, state)
            self._save()
            self._notify()

    def delete_class(self, name: str) -> None:
        with self._lock:
            resolved = self.resolve_class_name(name)
            if resolved is None:
                raise SchemaValidationError(f"class {name!r} not found")
            if self.tx is not None:
                self.tx.broadcast_commit(TX_DELETE_CLASS, {"class": resolved})
            self.apply_delete_class(resolved)

    def apply_delete_class(self, name: str) -> None:
        with self._lock:
            self.schema.classes.pop(name, None)
            self.sharding_states.pop(name, None)
            if self.migrator is not None:
                self.migrator.drop_class(name)
            self._save()
            self._notify()

    def _validate_property(self, cd: ClassDef, prop: Property, check_dup: bool = True) -> None:
        validate_property_name(prop.name)
        if prop.name.lower() in RESERVED_PROPERTY_NAMES:
            raise SchemaValidationError(f"property name {prop.name!r} is reserved")
        if check_dup and cd.get_property(prop.name) is not None:
            raise SchemaValidationError(f"property {prop.name!r} already exists")
        if not prop.data_type:
            raise SchemaValidationError(f"property {prop.name!r} has no dataType")
        if prop.primitive_type() is None:
            # cross-reference: every target class must exist (or be self)
            for target in prop.data_type:
                if target != cd.name and self.schema.get(target) is None:
                    raise SchemaValidationError(
                        f"property {prop.name!r}: unknown reference target {target!r}"
                    )

    def add_property(self, class_name: str, prop: Property | dict) -> Property:
        if isinstance(prop, dict):
            prop = Property.from_dict(prop)
        with self._lock:
            resolved = self.resolve_class_name(class_name)
            if resolved is None:
                raise SchemaValidationError(f"class {class_name!r} not found")
            cd = self.schema.get(resolved)
            self._validate_property(cd, prop)
            if self.tx is not None:
                self.tx.broadcast_commit(
                    TX_ADD_PROPERTY, {"class": resolved, "property": prop.to_dict()}
                )
            self.apply_add_property(resolved, prop)
            return prop

    def apply_add_property(self, class_name: str, prop: Property) -> None:
        with self._lock:
            cd = self.schema.get(class_name)
            if cd is None:
                return
            if cd.get_property(prop.name) is None:
                cd.properties.append(prop)
            if self.migrator is not None:
                self.migrator.update_class(cd)
            self._save()
            self._notify()

    def update_class(self, class_name: str, updated: dict) -> ClassDef:
        """Mutable: vectorIndexConfig hot fields, invertedIndexConfig,
        description, moduleConfig. Immutable: vectorizer, vectorIndexType,
        shardingConfig (usecases/schema update validation)."""
        with self._lock:
            resolved = self.resolve_class_name(class_name)
            if resolved is None:
                raise SchemaValidationError(f"class {class_name!r} not found")
            cd = self.schema.get(resolved)
            if "vectorizer" in updated and updated["vectorizer"] != cd.vectorizer:
                raise SchemaValidationError("vectorizer is immutable")
            if (
                "vectorIndexType" in updated
                and updated["vectorIndexType"] != cd.vector_index_type
            ):
                raise SchemaValidationError("vectorIndexType is immutable")
            if "shardingConfig" in updated:
                new_sh = ShardingConfig.from_dict(updated["shardingConfig"], len(self.node_names))
                cur_sh = ShardingConfig.from_dict(cd.sharding_config, len(self.node_names))
                if new_sh.desired_count != cur_sh.desired_count:
                    raise SchemaValidationError("shardingConfig.desiredCount is immutable")
            if "properties" in updated:
                from weaviate_tpu_torch.entities.schema import Property

                cur_props = [p.to_dict() for p in cd.properties]
                # normalize through Property so a fetch-tweak-PUT payload
                # with omitted default keys compares equal
                try:
                    new_props = [Property.from_dict(p).to_dict()
                                 for p in updated["properties"]]
                except (KeyError, TypeError, AttributeError) as e:
                    raise SchemaValidationError(
                        f"malformed properties payload: {e}") from e
                by_name = lambda props: sorted(props, key=lambda p: p.get("name", ""))  # noqa: E731
                if by_name(new_props) != by_name(cur_props):
                    # silent-ignore would ack a change that never happened;
                    # reject like the reference's update validation (new
                    # props go through POST .../properties; index-flag
                    # migration is the startup reindexer's job)
                    raise SchemaValidationError(
                        "properties are immutable on class update; add new "
                        "properties via POST /v1/schema/{class}/properties")
            payload = {"class": resolved, "updated": updated}
            if self.tx is not None:
                self.tx.broadcast_commit(TX_UPDATE_CLASS, payload)
            self.apply_update_class(resolved, updated)
            return self.schema.get(resolved)

    def apply_update_class(self, class_name: str, updated: dict) -> None:
        with self._lock:
            cd = self.schema.get(class_name)
            if cd is None:
                return
            if "vectorIndexConfig" in updated:
                old_cfg = self._parse_vi_config(cd)
                try:
                    new_cfg = vi.parse_and_validate_config(
                        cd.vector_index_type, updated["vectorIndexConfig"]
                    )
                    vi.validate_config_update(old_cfg, new_cfg)
                except vi.ConfigValidationError as e:
                    raise SchemaValidationError(str(e)) from e
                cd.vector_index_config = updated["vectorIndexConfig"]
                if self.migrator is not None:
                    self.migrator.update_vector_config(class_name, new_cfg)
            if "invertedIndexConfig" in updated:
                cd.inverted_index_config = updated["invertedIndexConfig"]
            if "description" in updated:
                cd.description = updated["description"]
            if "moduleConfig" in updated:
                cd.module_config = updated["moduleConfig"]
            if "replicationConfig" in updated:
                # replication-factor change: rebuild the ring with the new
                # replica count and hand the local shards to the scaler
                # (usecases/scaler/scaler.go trigger path). The file push
                # runs BEFORE the new state activates, so in-flight writes
                # keep targeting the old replica set during the copy; writes
                # landing in that window reach the new replica via read
                # repair afterwards.
                old_state = self.sharding_states.get(class_name)
                cd.replication_config = updated["replicationConfig"]
                new_state = self._mk_sharding_state(cd)
                if self.scaler is not None and old_state is not None:
                    self.scaler.scale(class_name, old_state, new_state)
                if self.migrator is not None and hasattr(self.migrator, "update_sharding_state"):
                    self.migrator.update_sharding_state(class_name, new_state)
            if self.migrator is not None:
                self.migrator.update_class(cd)
            self._save()
            self._notify()

    # -- shards status (schema/shards REST surface) --------------------------

    def shards_status(self, class_name: str) -> list[dict]:
        resolved = self.resolve_class_name(class_name)
        if resolved is None or self.migrator is None:
            raise SchemaValidationError(f"class {class_name!r} not found")
        idx = self.migrator.get_index(resolved)
        return idx.shards_status() if idx is not None else []

    def update_shard_status(self, class_name: str, shard_name: str, status: str) -> None:
        resolved = self.resolve_class_name(class_name)
        idx = self.migrator.get_index(resolved) if self.migrator else None
        if idx is None or shard_name not in idx.shards:
            raise SchemaValidationError(f"shard {class_name}/{shard_name} not found")
        idx.shards[shard_name].set_status(status.upper())
