# The port's copy of weaviate_tpu/modules/provider.py, its imports pointed at the port; `Provider` and
# `build_provider` take the `device` the modules' device work runs on.
"""Modules provider: registry + dispatch.

Reference: usecases/modules/modules.go (Provider) + vectorizer.go — the one
object the use-case layer talks to: vectorize on import, resolve near-args
(nearText with moveTo/moveAwayFrom vector steering), validate per-class
module config, aggregate module meta, and hand backup backends to the
backup scheduler.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from weaviate_tpu_torch.modules.interface import (
    BackupBackend,
    Module,
    Vectorizer,
)


class ModuleError(ValueError):
    pass


def corpus_from_object(class_def, obj, module_cfg: dict, module_name: str = "") -> str:
    """Build the text corpus the vectorizer embeds
    (text2vec-contextionary vectorizer semantics: optional class name +
    non-skipped text property values, lowercased). Per-property module
    config may be nested under the module name ({"text2vec-x": {"skip":
    true}}) or flat ({"skip": true}); only the ACTIVE module's entry
    applies."""
    parts: list[str] = []
    if module_cfg.get("vectorizeClassName", True):
        parts.append(class_def.name)
    for prop in class_def.properties:
        pcfg = (prop.module_config or {}) if hasattr(prop, "module_config") else {}
        if module_name and module_name in pcfg:
            flat = pcfg[module_name] or {}
        elif pcfg and not any(isinstance(v, dict) for v in pcfg.values()):
            flat = pcfg  # flat form, no module nesting
        else:
            flat = {}
        if flat.get("skip"):
            continue
        dt = prop.data_type[0] if prop.data_type else ""
        if dt not in ("text", "string", "text[]", "string[]"):
            continue
        val = obj.properties.get(prop.name)
        if val is None:
            continue
        if isinstance(val, list):
            parts.extend(str(v) for v in val)
        else:
            parts.append(str(val))
    return " ".join(parts).lower()


class Provider:
    """usecases/modules/modules.go Provider analog.

    `device` is where the modules that do device work run (the explainers'
    featureProjection t-SNE): register hands it to each of them, and
    setting it hands it to those already registered. None leaves a
    module's own device as it is."""

    def __init__(self, device=None):
        self._modules: dict[str, Module] = {}
        self._device = device

    @property
    def device(self):
        return self._device

    @device.setter
    def device(self, device) -> None:
        self._device = device
        for m in self._modules.values():
            self._hand_device(m)

    def _hand_device(self, module: Module) -> None:
        from weaviate_tpu_torch.modules.explain import SemanticExplainer

        if self._device is not None and isinstance(module, SemanticExplainer):
            module.device = self._device

    def register(self, module: Module) -> None:
        from weaviate_tpu_torch.modules.explain import EXPLAIN_PROPS
        from weaviate_tpu_torch.modules.interface import AdditionalProperties

        self._hand_device(module)

        if isinstance(module, AdditionalProperties):
            # explain props are class-vectorizer-scoped by dispatch
            # (additional_property_module), so sharing them is expected;
            # any other overlap means first-registered silently wins — warn
            mine = set(module.additional_properties()) - set(EXPLAIN_PROPS)
            for other in self._modules.values():
                if not isinstance(other, AdditionalProperties):
                    continue
                clash = mine & set(other.additional_properties())
                if clash:
                    import logging

                    logging.getLogger(__name__).warning(
                        "modules %r and %r both resolve _additional props %s; "
                        "%r (registered first) wins",
                        other.name, module.name, sorted(clash), other.name)
        self._modules[module.name] = module

    def get(self, name: str) -> Optional[Module]:
        return self._modules.get(name)

    def names(self) -> list[str]:
        return sorted(self._modules)

    def meta(self) -> dict:
        return {name: m.meta() for name, m in self._modules.items()}

    # -- vectorizer dispatch -------------------------------------------------

    def _vectorizer_for(self, class_def) -> Optional[Vectorizer]:
        name = getattr(class_def, "vectorizer", "none") or "none"
        if name == "none":
            return None
        mod = self._modules.get(name)
        if mod is None:
            raise ModuleError(
                f"class {class_def.name!r} uses vectorizer {name!r} which is "
                f"not enabled (enabled: {self.names()})"
            )
        if not isinstance(mod, Vectorizer):
            raise ModuleError(f"module {name!r} is not a vectorizer")
        return mod

    def _class_module_cfg(self, class_def, name: str) -> dict:
        cfg = getattr(class_def, "module_config", None) or {}
        return cfg.get(name) or {}

    def vectorize_object(self, class_def, obj) -> Optional[np.ndarray]:
        """Vectorize-at-import (modules/vectorizer.go UpdateVector path)."""
        vec = self._vectorizer_for(class_def)
        if vec is None:
            return None
        mod_cfg = self._class_module_cfg(class_def, class_def.vectorizer)
        return vec.vectorize_object(class_def, obj, mod_cfg)

    def vectorize_query(self, class_def, near_text: dict) -> Optional[np.ndarray]:
        """nearText -> query vector with moveTo/moveAwayFrom steering
        (traverser near_params_vector.go + text2vec concepts math: move the
        query point toward/away from the concepts' centroid by `force`)."""
        vec = self._vectorizer_for(class_def)
        if vec is None:
            raise ModuleError(
                f"class {class_def.name!r} has no vectorizer; nearText needs one"
            )
        concepts = near_text.get("concepts") or []
        if isinstance(concepts, str):
            concepts = [concepts]
        if not concepts:
            raise ModuleError("nearText requires at least one concept")
        base = vec.vectorize_text([" ".join(str(c) for c in concepts)])[0]
        base_norm = float(np.linalg.norm(base))

        def centroid(spec) -> Optional[np.ndarray]:
            if not spec:
                return None
            texts = spec.get("concepts") or []
            if isinstance(texts, str):
                texts = [texts]
            if not texts:
                return None
            return vec.vectorize_text([" ".join(map(str, texts))])[0]

        move_to = near_text.get("moveTo") or {}
        move_away = near_text.get("moveAwayFrom") or {}
        to_c = centroid(move_to)
        if to_c is not None:
            f = float(move_to.get("force", 0.0))
            base = base * (1.0 - f) + to_c * f
        away_c = centroid(move_away)
        if away_c is not None:
            f = float(move_away.get("force", 0.0))
            base = base + f * (base - away_c)
        if to_c is not None or away_c is not None:
            # steering changed the magnitude: restore the embedder's own
            # scale so query and stored-vector geometry stay consistent
            # (an embedder that emits unnormalized vectors keeps them so)
            n = np.linalg.norm(base)
            if n > 0 and base_norm > 0:
                base = base * (base_norm / n)
        return base.astype(np.float32)

    def vectorization_input(self, class_def, obj):
        """Canonical embedding input for change detection, or None."""
        vec = self._vectorizer_for(class_def)
        if vec is None:
            return None
        mod_cfg = self._class_module_cfg(class_def, class_def.vectorizer)
        return vec.vectorize_input(class_def, obj, mod_cfg)

    def vectorize_texts(self, class_def, texts: Sequence[str]) -> np.ndarray:
        vec = self._vectorizer_for(class_def)
        if vec is None:
            raise ModuleError(f"class {class_def.name!r} has no vectorizer")
        return vec.vectorize_text(list(texts))

    # -- module additional properties (modulecapabilities/additional.go) -----

    def additional_property_module(self, prop: str, class_def=None):
        from weaviate_tpu_torch.modules.interface import AdditionalProperties

        from weaviate_tpu_torch.modules.explain import EXPLAIN_PROPS

        # explain props score against the class's embedding space, so only
        # the class's OWN vectorizer may resolve them — another module's
        # vocab vectors would be a different dimensionality/geometry
        # entirely (crash or nonsense). Space-independent props (answer,
        # summary, generate, ...) keep the any-module fallback.
        if class_def is not None and prop in EXPLAIN_PROPS:
            own = self._modules.get(getattr(class_def, "vectorizer", "") or "")
            if isinstance(own, AdditionalProperties) and prop in own.additional_properties():
                return own
            raise ModuleError(
                f"_additional.{prop!r} needs the class's vectorizer module; "
                f"class {getattr(class_def, 'name', '?')!r} has "
                f"{getattr(class_def, 'vectorizer', 'none') or 'none'!r}"
            )
        for m in self._modules.values():
            if isinstance(m, AdditionalProperties) and prop in m.additional_properties():
                return m
        return None

    def additional_properties(self) -> list[str]:
        from weaviate_tpu_torch.modules.interface import AdditionalProperties

        out = []
        for m in self._modules.values():
            if isinstance(m, AdditionalProperties):
                out.extend(m.additional_properties())
        return sorted(set(out))

    def transform_text(self, texts: Sequence[str]) -> list[str]:
        """Run query texts through every enabled TextTransformer (the
        autocorrect hook, modulecapabilities/texttransformer.go); identity
        when none is enabled."""
        from weaviate_tpu_torch.modules.interface import TextTransformer

        out = [str(t) for t in texts]
        for m in self._modules.values():
            if isinstance(m, TextTransformer):
                out = m.transform(out)
        return out

    def has_text_transformer(self) -> bool:
        from weaviate_tpu_torch.modules.interface import TextTransformer

        return any(isinstance(m, TextTransformer) for m in self._modules.values())

    def graphql_arguments(self) -> list[str]:
        """near-args contributed by enabled modules (nearText, nearImage,
        ...) — feeds GraphQL arg validation (modulecapabilities/graphql.go)."""
        from weaviate_tpu_torch.modules.interface import GraphQLArguments

        out = []
        for m in self._modules.values():
            if isinstance(m, GraphQLArguments):
                out.extend(m.arguments())
        return sorted(set(out))

    def resolve_additional(self, prop: str, results, params: dict, class_def=None):
        mod = self.additional_property_module(prop, class_def)
        if mod is None:
            raise ModuleError(f"no enabled module resolves _additional.{prop!r}")
        return mod.resolve_additional(prop, results, params)

    # -- media query vectors ---------------------------------------------------

    def vectorize_image_query(self, class_def, near_image: dict) -> np.ndarray:
        """nearImage -> query vector via the class's (media) vectorizer."""
        vec = self._vectorizer_for(class_def)
        if vec is None or not hasattr(vec, "vectorize_image"):
            raise ModuleError(
                f"class {class_def.name!r} has no image-capable vectorizer"
            )
        image = near_image.get("image") or ""
        if not image:
            raise ModuleError("nearImage requires {image: <base64>}")
        return np.asarray(vec.vectorize_image(image), dtype=np.float32)

    # -- backup backends -----------------------------------------------------

    def handle_module_rest(self, module_name: str, method: str, path: str,
                           body) -> tuple[int, dict]:
        """Dispatch /v1/modules/<module-name>/<path> to the module's REST
        surface (middlewares.go:66 mounts each module's RootHandler)."""
        from weaviate_tpu_torch.modules.interface import ModuleRest

        mod = self.get(module_name)
        if mod is None:
            return 404, {"error": [{"message":
                f"module {module_name!r} is not enabled"}]}
        if not isinstance(mod, ModuleRest):
            return 405, {"error": [{"message":
                f"module {module_name!r} exposes no REST surface"}]}
        return mod.handle_rest(method, path, body)

    def backup_backend(self, name: str) -> Optional[BackupBackend]:
        mod = self._modules.get(name) or self._modules.get(f"backup-{name}")
        if mod is not None and isinstance(mod, BackupBackend):
            return mod
        return None

    def shutdown(self) -> None:
        for m in self._modules.values():
            m.shutdown()


def build_provider(config, device=None) -> Optional[Provider]:
    """registerModules (configure_api.go:471): instantiate the modules named
    in ENABLE_MODULES, their device work on `device` (None: the card).
    Unknown names raise — a typo'd module must not silently no-op."""
    enabled = list(getattr(config, "enable_modules", []) or [])
    if not enabled:
        return None
    p = Provider(device=device)
    for name in enabled:
        name = name.strip()
        if not name:
            continue
        if name in ("text2vec-local", "text2vec-hash"):
            import os as _os

            from weaviate_tpu_torch.modules.text2vec_local import LocalTextVectorizer

            data_path = getattr(
                getattr(config, "persistence", None), "data_path", "") or ""
            p.register(LocalTextVectorizer(name=name, persist_path=(
                _os.path.join(data_path, "modules", name, "extensions.json")
                if data_path else None)))
        elif name == "text2vec-contextionary":
            from weaviate_tpu_torch.modules.text2vec_contextionary import (
                ContextionaryVectorizer,
            )

            p.register(ContextionaryVectorizer(url=getattr(config, "contextionary_url", "")))
        elif name == "ref2vec-centroid":
            from weaviate_tpu_torch.modules.ref2vec_centroid import Ref2VecCentroid

            p.register(Ref2VecCentroid())
        elif name == "backup-filesystem":
            from weaviate_tpu_torch.modules.backup_fs import FilesystemBackupBackend

            p.register(FilesystemBackupBackend(
                getattr(config, "backup_filesystem_path", "") or "./backups"))
        elif name == "text2vec-transformers":
            from weaviate_tpu_torch.modules.text2vec_http import TransformersVectorizer

            p.register(TransformersVectorizer(_env("TRANSFORMERS_INFERENCE_API")))
        elif name == "text2vec-openai":
            from weaviate_tpu_torch.modules.text2vec_http import OpenAIVectorizer

            p.register(OpenAIVectorizer(
                _env("OPENAI_APIKEY"),
                model=_env("OPENAI_EMBEDDING_MODEL") or "text-embedding-3-small",
                base_url=_env("OPENAI_BASE_URL") or "https://api.openai.com/v1"))
        elif name == "text2vec-cohere":
            from weaviate_tpu_torch.modules.text2vec_http import CohereVectorizer

            p.register(CohereVectorizer(
                _env("COHERE_APIKEY"),
                base_url=_env("COHERE_BASE_URL") or "https://api.cohere.ai/v1"))
        elif name == "text2vec-huggingface":
            from weaviate_tpu_torch.modules.text2vec_http import HuggingFaceVectorizer

            p.register(HuggingFaceVectorizer(
                _env("HUGGINGFACE_APIKEY"),
                base_url=_env("HUGGINGFACE_BASE_URL")
                or "https://api-inference.huggingface.co"))
        elif name == "qna-transformers":
            from weaviate_tpu_torch.modules.readers import QnATransformers

            p.register(QnATransformers(_env("QNA_INFERENCE_API")))
        elif name == "qna-openai":
            from weaviate_tpu_torch.modules.readers import QnAOpenAI

            p.register(QnAOpenAI(
                _env("OPENAI_APIKEY"),
                model=_env("QNA_OPENAI_MODEL") or "gpt-4o-mini",
                base_url=_env("OPENAI_BASE_URL") or "https://api.openai.com/v1"))
        elif name == "sum-transformers":
            from weaviate_tpu_torch.modules.readers import SumTransformers

            p.register(SumTransformers(_env("SUM_INFERENCE_API")))
        elif name == "ner-transformers":
            from weaviate_tpu_torch.modules.readers import NerTransformers

            p.register(NerTransformers(_env("NER_INFERENCE_API")))
        elif name == "text-spellcheck":
            from weaviate_tpu_torch.modules.readers import TextSpellcheck

            p.register(TextSpellcheck(_env("SPELLCHECK_INFERENCE_API")))
        elif name == "generative-openai":
            from weaviate_tpu_torch.modules.readers import GenerativeOpenAI

            p.register(GenerativeOpenAI(
                _env("OPENAI_APIKEY"),
                model=_env("OPENAI_GENERATIVE_MODEL") or "gpt-4o-mini",
                base_url=_env("OPENAI_BASE_URL") or "https://api.openai.com/v1"))
        elif name == "img2vec-neural":
            from weaviate_tpu_torch.modules.media import Img2VecNeural

            p.register(Img2VecNeural(_env("IMAGE_INFERENCE_API")))
        elif name == "multi2vec-clip":
            from weaviate_tpu_torch.modules.media import Multi2VecClip

            p.register(Multi2VecClip(_env("CLIP_INFERENCE_API")))
        elif name == "backup-s3":
            from weaviate_tpu_torch.modules.backup_cloud import S3BackupBackend

            p.register(S3BackupBackend(
                bucket=_env("BACKUP_S3_BUCKET"),
                access_key=_env("AWS_ACCESS_KEY_ID"),
                secret_key=_env("AWS_SECRET_ACCESS_KEY"),
                region=_env("AWS_REGION") or "us-east-1",
                endpoint=_env("BACKUP_S3_ENDPOINT"),
                path_prefix=_env("BACKUP_S3_PATH")))
        elif name == "backup-gcs":
            from weaviate_tpu_torch.modules.backup_cloud import GCSBackupBackend

            p.register(GCSBackupBackend(
                bucket=_env("BACKUP_GCS_BUCKET"), token=_env("BACKUP_GCS_TOKEN"),
                base_url=_env("BACKUP_GCS_ENDPOINT") or "https://storage.googleapis.com"))
        elif name == "backup-azure":
            from weaviate_tpu_torch.modules.backup_cloud import AzureBackupBackend

            p.register(AzureBackupBackend(
                account=_env("AZURE_STORAGE_ACCOUNT"),
                container=_env("BACKUP_AZURE_CONTAINER"),
                sas_token=_env("AZURE_STORAGE_SAS_TOKEN"),
                base_url=_env("AZURE_BLOB_ENDPOINT")))
        else:
            raise ModuleError(f"unknown module {name!r} in ENABLE_MODULES")
    return p


def _env(name: str) -> str:
    import os

    return os.environ.get(name, "")
