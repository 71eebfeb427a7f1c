# The port's copy of weaviate_tpu/modules/readers.py, its imports pointed at the port.
"""Reader / generator / token modules: qna, summarization, NER, spellcheck,
and generative completion.

Reference clients:
- modules/qna-transformers/clients/ — POST {url}/answers/ with
  {"text", "question"} -> extractive answer span (QNA_INFERENCE_API).
- modules/sum-transformers/clients/ — POST {url}/sum/ -> summaries.
- modules/ner-transformers/clients/ — POST {url}/ner/ -> tokens.
- modules/text-spellcheck/clients/ — POST {url}/spellcheck/.
- modules/generative-openai/clients/ — chat completions over the results
  (the `generate` additional property).

Each resolves an `_additional` property over result objects
(modulecapabilities/additional.go): the GraphQL layer calls
resolve_additional(prop, results, params) and splices the payload into each
result's _additional map.
"""

from __future__ import annotations

from typing import Optional

from weaviate_tpu_torch.modules.interface import (
    AdditionalProperties,
    Module,
    TextTransformer,
)
from weaviate_tpu_torch.modules.provider import ModuleError
from weaviate_tpu_torch.modules.sidecar import http_json


def _text_of(obj, properties: Optional[list[str]] = None) -> str:
    props = obj.properties or {}
    keys = properties or [k for k, v in props.items() if isinstance(v, str)]
    return " ".join(str(props[k]) for k in keys if k in props)


class QnATransformers(Module, AdditionalProperties):
    """qna-transformers: extractive question answering over each result."""

    def __init__(self, url: str, timeout: float = 30.0):
        if not url:
            raise ModuleError("qna-transformers requires QNA_INFERENCE_API")
        self.url = url.rstrip("/")
        self.timeout = timeout

    @property
    def name(self) -> str:
        return "qna-transformers"

    @property
    def module_type(self) -> str:
        return "qna"

    def meta(self) -> dict:
        return {"type": "qna", "url": self.url}

    def additional_properties(self) -> list[str]:
        return ["answer"]

    def resolve_additional(self, prop: str, results, params: dict):
        question = (params or {}).get("question", "")
        if not question:
            raise ModuleError("_additional.answer requires ask{question}")
        properties = (params or {}).get("properties")
        out = []
        for r in results:
            reply = http_json(
                f"{self.url}/answers",
                {"text": _text_of(r.obj, properties), "question": question},
                timeout=self.timeout,
            )
            out.append({
                "result": reply.get("answer"),
                "certainty": reply.get("certainty"),
                "hasAnswer": reply.get("answer") is not None,
                "property": reply.get("property"),
                "startPosition": reply.get("startPosition", 0),
                "endPosition": reply.get("endPosition", 0),
            })
        return out


class SumTransformers(Module, AdditionalProperties):
    """sum-transformers: per-result property summaries."""

    def __init__(self, url: str, timeout: float = 60.0):
        if not url:
            raise ModuleError("sum-transformers requires SUM_INFERENCE_API")
        self.url = url.rstrip("/")
        self.timeout = timeout

    @property
    def name(self) -> str:
        return "sum-transformers"

    @property
    def module_type(self) -> str:
        return "sum"

    def meta(self) -> dict:
        return {"type": "sum", "url": self.url}

    def additional_properties(self) -> list[str]:
        return ["summary"]

    def resolve_additional(self, prop: str, results, params: dict):
        properties = (params or {}).get("properties") or []
        out = []
        for r in results:
            summaries = []
            for pname in properties or list(r.obj.properties):
                val = r.obj.properties.get(pname)
                if not isinstance(val, str) or not val.strip():
                    continue
                reply = http_json(
                    f"{self.url}/sum", {"text": val}, timeout=self.timeout
                )
                summaries.append({
                    "property": pname,
                    "result": reply.get("summary", ""),
                })
            out.append(summaries)
        return out


class NerTransformers(Module, AdditionalProperties):
    """ner-transformers: named-entity tokens per result."""

    def __init__(self, url: str, timeout: float = 30.0):
        if not url:
            raise ModuleError("ner-transformers requires NER_INFERENCE_API")
        self.url = url.rstrip("/")
        self.timeout = timeout

    @property
    def name(self) -> str:
        return "ner-transformers"

    @property
    def module_type(self) -> str:
        return "ner"

    def meta(self) -> dict:
        return {"type": "ner", "url": self.url}

    def additional_properties(self) -> list[str]:
        return ["tokens"]

    def resolve_additional(self, prop: str, results, params: dict):
        properties = (params or {}).get("properties")
        out = []
        for r in results:
            reply = http_json(
                f"{self.url}/ner",
                {"text": _text_of(r.obj, properties)},
                timeout=self.timeout,
            )
            out.append(reply.get("tokens", []))
        return out


class TextSpellcheck(Module, AdditionalProperties, TextTransformer):
    """text-spellcheck: query-text corrections (spellCheck additional) and
    the autocorrect transformer (modules/text-spellcheck/transformer/
    autocorrect — bm25/nearText queries with autocorrect: true run their
    text through the corrector before searching)."""

    def __init__(self, url: str, timeout: float = 10.0):
        if not url:
            raise ModuleError("text-spellcheck requires SPELLCHECK_INFERENCE_API")
        self.url = url.rstrip("/")
        self.timeout = timeout

    @property
    def name(self) -> str:
        return "text-spellcheck"

    @property
    def module_type(self) -> str:
        return "text"

    def meta(self) -> dict:
        return {"type": "spellcheck", "url": self.url}

    def additional_properties(self) -> list[str]:
        return ["spellCheck"]

    def check(self, text: str) -> dict:
        return http_json(f"{self.url}/spellcheck", {"text": text}, timeout=self.timeout)

    def resolve_additional(self, prop: str, results, params: dict):
        text = (params or {}).get("text", "")
        reply = self.check(text)
        return [reply for _ in results]

    def transform(self, texts):
        """Autocorrect each text: the sidecar's didYouMean replaces the
        input when it proposes corrections."""
        out = []
        for t in texts:
            reply = self.check(str(t))
            corrected = reply.get("didYouMean")
            out.append(corrected if corrected and reply.get(
                "numberOfCorrections", 0) else str(t))
        return out


class GenerativeOpenAI(Module, AdditionalProperties):
    """generative-openai: single-result and grouped-result generation
    (the `generate` additional property)."""

    def __init__(self, api_key: str, model: str = "gpt-4o-mini",
                 base_url: str = "https://api.openai.com/v1", timeout: float = 120.0):
        if not api_key:
            raise ModuleError("generative-openai requires OPENAI_APIKEY")
        self.api_key = api_key
        self.model = model
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    @property
    def name(self) -> str:
        return "generative-openai"

    @property
    def module_type(self) -> str:
        return "generative"

    def meta(self) -> dict:
        return {"type": "generative", "provider": "openai", "model": self.model}

    def additional_properties(self) -> list[str]:
        return ["generate"]

    def _complete(self, prompt: str) -> str:
        reply = http_json(
            f"{self.base_url}/chat/completions",
            {"model": self.model,
             "messages": [{"role": "user", "content": prompt}]},
            headers={"Authorization": f"Bearer {self.api_key}"},
            timeout=self.timeout,
        )
        choices = reply.get("choices") or []
        if not choices:
            raise ModuleError(f"generative-openai returned no choices: {reply}")
        return choices[0].get("message", {}).get("content", "")

    @staticmethod
    def _fill(template: str, obj) -> str:
        out = template
        for k, v in (obj.properties or {}).items():
            out = out.replace("{" + k + "}", str(v))
        return out

    def resolve_additional(self, prop: str, results, params: dict):
        params = params or {}
        single = params.get("singleResult") or params.get("singlePrompt")
        grouped = params.get("groupedResult") or params.get("groupedTask")
        if single:
            prompt_t = single.get("prompt") if isinstance(single, dict) else str(single)
            return [
                {"singleResult": self._complete(self._fill(prompt_t, r.obj)),
                 "error": None}
                for r in results
            ]
        if grouped:
            task = grouped.get("task") if isinstance(grouped, dict) else str(grouped)
            corpus = "\n".join(
                str(r.obj.properties) for r in results
            )
            text = self._complete(f"{task}\n\n{corpus}")
            return [
                {"groupedResult": text if i == 0 else None, "error": None}
                for i in range(len(results))
            ]
        raise ModuleError("generate requires singleResult{prompt} or groupedResult{task}")


class QnAOpenAI(Module, AdditionalProperties):
    """qna-openai: extractive question answering through the OpenAI
    completions API (modules/qna-openai — the SaaS twin of
    qna-transformers; same `ask`/`_additional.answer` surface)."""

    def __init__(self, api_key: str, model: str = "gpt-4o-mini",
                 base_url: str = "https://api.openai.com/v1", timeout: float = 60.0):
        if not api_key:
            raise ModuleError("qna-openai requires OPENAI_APIKEY")
        self.api_key = api_key
        self.model = model
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    @property
    def name(self) -> str:
        return "qna-openai"

    @property
    def module_type(self) -> str:
        return "qna"

    def meta(self) -> dict:
        return {"type": "qna", "provider": "openai", "model": self.model}

    def additional_properties(self) -> list[str]:
        return ["answer"]

    def _ask(self, text: str, question: str) -> Optional[str]:
        reply = http_json(
            f"{self.base_url}/chat/completions",
            {"model": self.model,
             "messages": [{
                 "role": "user",
                 "content": (
                     "Answer strictly from the text; reply with the exact "
                     "answer span only, or the single word NONE if the text "
                     f"does not answer it.\n\nText: {text}\n\n"
                     f"Question: {question}"
                 ),
             }]},
            headers={"Authorization": f"Bearer {self.api_key}"},
            timeout=self.timeout,
        )
        choices = reply.get("choices") or []
        if not choices:
            raise ModuleError(f"qna-openai returned no choices: {reply}")
        answer = (choices[0].get("message", {}).get("content") or "").strip()
        return None if not answer or answer.upper() == "NONE" else answer

    def resolve_additional(self, prop: str, results, params: dict):
        question = (params or {}).get("question", "")
        if not question:
            raise ModuleError("_additional.answer requires ask{question}")
        properties = (params or {}).get("properties")
        out = []
        for r in results:
            text = _text_of(r.obj, properties)
            answer = self._ask(text, question)
            pos = -1
            if answer:
                # case-insensitive span location: models routinely change
                # capitalization of an otherwise-exact extract
                pos = text.lower().find(answer.lower())
            out.append({
                # same payload shape as qna-transformers (certainty always
                # present) so switching modules never breaks clients
                "result": answer,
                "certainty": None,
                "hasAnswer": answer is not None,
                "property": None,
                "startPosition": max(pos, 0),
                "endPosition": (pos + len(answer)) if answer and pos >= 0 else 0,
            })
        return out
