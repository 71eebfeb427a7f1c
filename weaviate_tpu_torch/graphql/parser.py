# The port's copy of weaviate_tpu/graphql/parser.py, its imports pointed at the port.
"""GraphQL query parser (lexer + recursive descent -> light AST).

Covers the GraphQL-spec query subset the Weaviate API surface uses:
operation (query/anonymous, with variable definitions), selection sets,
field arguments with Int/Float/String/Boolean/Enum/List/Object/Variable
values, aliases, inline fragments (`... on Class`), and named fragments.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


class GraphQLParseError(ValueError):
    pass


@dataclass
class EnumValue:
    """Distinguishes `Equal` (enum token) from `"Equal"` (string)."""

    name: str

    def __str__(self) -> str:
        return self.name


@dataclass
class Variable:
    name: str


# sentinel: variable declared without a default — must be provided at execute
_REQUIRED = object()


@dataclass
class Field:
    name: str
    alias: Optional[str] = None
    args: dict[str, Any] = field(default_factory=dict)
    selections: list = field(default_factory=list)

    @property
    def out_name(self) -> str:
        return self.alias or self.name


@dataclass
class InlineFragment:
    type_name: str
    selections: list = field(default_factory=list)


@dataclass
class FragmentSpread:
    name: str


@dataclass
class Operation:
    kind: str = "query"
    name: Optional[str] = None
    variable_defaults: dict[str, Any] = field(default_factory=dict)
    selections: list = field(default_factory=list)


@dataclass
class Document:
    operation: Operation
    fragments: dict[str, InlineFragment] = field(default_factory=dict)


# -- lexer -------------------------------------------------------------------

_PUNCT = set("{}()[]:,=!$@")


def _tokenize(src: str) -> list[tuple[str, Any]]:
    toks: list[tuple[str, Any]] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n,":
            i += 1
            continue
        if c == "#":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if src.startswith("...", i):
            toks.append(("ellipsis", "..."))
            i += 3
            continue
        if c in _PUNCT:
            toks.append(("punct", c))
            i += 1
            continue
        if c == '"':
            if src.startswith('"""', i):
                end = src.find('"""', i + 3)
                if end < 0:
                    raise GraphQLParseError("unterminated block string")
                toks.append(("string", src[i + 3 : end]))
                i = end + 3
                continue
            j = i + 1
            buf = []
            while j < n:
                if src[j] == "\\":
                    if j + 1 >= n:
                        raise GraphQLParseError("unterminated string escape")
                    esc = src[j + 1]
                    mapping = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\", "/": "/"}
                    if esc == "u":
                        if j + 6 > n:
                            raise GraphQLParseError("unterminated unicode escape")
                        try:
                            buf.append(chr(int(src[j + 2 : j + 6], 16)))
                        except ValueError:
                            raise GraphQLParseError(
                                f"invalid unicode escape {src[j : j + 6]!r}"
                            ) from None
                        j += 6
                        continue
                    buf.append(mapping.get(esc, esc))
                    j += 2
                    continue
                if src[j] == '"':
                    break
                buf.append(src[j])
                j += 1
            if j >= n:
                raise GraphQLParseError("unterminated string")
            toks.append(("string", "".join(buf)))
            i = j + 1
            continue
        if c.isdigit() or (c == "-" and i + 1 < n and (src[i + 1].isdigit() or src[i + 1] == ".")):
            j = i + 1
            while j < n and (src[j].isdigit() or src[j] in ".eE+-"):
                # stop if +/- not after e/E
                if src[j] in "+-" and src[j - 1] not in "eE":
                    break
                j += 1
            text = src[i:j]
            try:
                if any(ch in text for ch in ".eE"):
                    toks.append(("float", float(text)))
                else:
                    toks.append(("int", int(text)))
            except ValueError:
                raise GraphQLParseError(f"malformed number literal {text!r}") from None
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i + 1
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            toks.append(("name", src[i:j]))
            i = j
            continue
        raise GraphQLParseError(f"unexpected character {c!r} at offset {i}")
    toks.append(("eof", None))
    return toks


# -- parser ------------------------------------------------------------------


class _Parser:
    def __init__(self, toks: list[tuple[str, Any]], variables: dict[str, Any]):
        self.toks = toks
        self.pos = 0
        self.variables = variables

    def peek(self):
        return self.toks[self.pos]

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect_punct(self, ch: str):
        kind, val = self.next()
        if kind != "punct" or val != ch:
            raise GraphQLParseError(f"expected {ch!r}, got {val!r}")

    def expect_name(self) -> str:
        kind, val = self.next()
        if kind != "name":
            raise GraphQLParseError(f"expected name, got {val!r}")
        return val

    def parse_document(self) -> Document:
        op: Optional[Operation] = None
        fragments: dict[str, InlineFragment] = {}
        while self.peek()[0] != "eof":
            kind, val = self.peek()
            if kind == "punct" and val == "{":
                if op is not None:
                    raise GraphQLParseError("multiple anonymous operations")
                op = Operation(selections=self.parse_selection_set())
            elif kind == "name" and val in ("query",):
                self.next()
                o = Operation()
                if self.peek()[0] == "name":
                    o.name = self.next()[1]
                if self.peek() == ("punct", "("):
                    self._parse_variable_defs(o)
                o.selections = self.parse_selection_set()
                if op is not None:
                    raise GraphQLParseError("multiple operations not supported")
                op = o
            elif kind == "name" and val in ("mutation", "subscription"):
                raise GraphQLParseError(f"{val} operations are not supported")
            elif kind == "name" and val == "fragment":
                self.next()
                fname = self.expect_name()
                on = self.expect_name()
                if on != "on":
                    raise GraphQLParseError("expected 'on' in fragment definition")
                tname = self.expect_name()
                fragments[fname] = InlineFragment(tname, self.parse_selection_set())
            else:
                raise GraphQLParseError(f"unexpected token {val!r}")
        if op is None:
            raise GraphQLParseError("no operation in document")
        return Document(op, fragments)

    def _parse_variable_defs(self, op: Operation):
        self.expect_punct("(")
        while self.peek() != ("punct", ")"):
            self.expect_punct("$")
            vname = self.expect_name()
            self.expect_punct(":")
            self._skip_type()
            default = _REQUIRED
            if self.peek() == ("punct", "="):
                self.next()
                default = self.parse_value()
            op.variable_defaults[vname] = default
        self.next()  # )

    def _skip_type(self):
        kind, val = self.next()
        if kind == "punct" and val == "[":
            self._skip_type()
            self.expect_punct("]")
        elif kind != "name":
            raise GraphQLParseError(f"expected type, got {val!r}")
        if self.peek() == ("punct", "!"):
            self.next()

    def parse_selection_set(self) -> list:
        self.expect_punct("{")
        out = []
        while self.peek() != ("punct", "}"):
            kind, val = self.peek()
            if kind == "ellipsis":
                self.next()
                k2, v2 = self.peek()
                if k2 == "name" and v2 == "on":
                    self.next()
                    tname = self.expect_name()
                    out.append(InlineFragment(tname, self.parse_selection_set()))
                else:
                    out.append(FragmentSpread(self.expect_name()))
                continue
            if kind != "name":
                raise GraphQLParseError(f"expected field name, got {val!r}")
            name = self.next()[1]
            f = Field(name=name)
            if self.peek() == ("punct", ":"):
                self.next()
                f.alias, f.name = name, self.expect_name()
            if self.peek() == ("punct", "("):
                f.args = self.parse_arguments()
            # skip directives
            while self.peek() == ("punct", "@"):
                self.next()
                self.expect_name()
                if self.peek() == ("punct", "("):
                    self.parse_arguments()
            if self.peek() == ("punct", "{"):
                f.selections = self.parse_selection_set()
            out.append(f)
        self.next()  # }
        return out

    def parse_arguments(self) -> dict[str, Any]:
        self.expect_punct("(")
        args = {}
        while self.peek() != ("punct", ")"):
            name = self.expect_name()
            self.expect_punct(":")
            args[name] = self.parse_value()
        self.next()  # )
        return args

    def parse_value(self) -> Any:
        kind, val = self.next()
        if kind in ("int", "float", "string"):
            return val
        if kind == "punct" and val == "$":
            vname = self.expect_name()
            return Variable(vname)
        if kind == "punct" and val == "[":
            out = []
            while self.peek() != ("punct", "]"):
                out.append(self.parse_value())
            self.next()
            return out
        if kind == "punct" and val == "{":
            obj = {}
            while self.peek() != ("punct", "}"):
                k = self.expect_name()
                self.expect_punct(":")
                obj[k] = self.parse_value()
            self.next()
            return obj
        if kind == "name":
            if val == "true":
                return True
            if val == "false":
                return False
            if val == "null":
                return None
            return EnumValue(val)
        raise GraphQLParseError(f"unexpected value token {val!r}")


def _resolve(value: Any, variables: dict[str, Any], defaults: dict[str, Any]) -> Any:
    if isinstance(value, Variable):
        if value.name in variables:
            return variables[value.name]
        if value.name in defaults and defaults[value.name] is not _REQUIRED:
            return defaults[value.name]
        raise GraphQLParseError(f"variable ${value.name} not provided")
    if isinstance(value, list):
        return [_resolve(v, variables, defaults) for v in value]
    if isinstance(value, dict):
        return {k: _resolve(v, variables, defaults) for k, v in value.items()}
    return value


def _resolve_selections(sels: list, variables, defaults, fragments) -> list:
    out = []
    for s in sels:
        if isinstance(s, FragmentSpread):
            frag = fragments.get(s.name)
            if frag is None:
                raise GraphQLParseError(f"unknown fragment {s.name!r}")
            out.append(
                InlineFragment(
                    frag.type_name,
                    _resolve_selections(frag.selections, variables, defaults, fragments),
                )
            )
        elif isinstance(s, InlineFragment):
            out.append(
                InlineFragment(
                    s.type_name,
                    _resolve_selections(s.selections, variables, defaults, fragments),
                )
            )
        else:
            out.append(
                Field(
                    name=s.name,
                    alias=s.alias,
                    args={k: _resolve(v, variables, defaults) for k, v in s.args.items()},
                    selections=_resolve_selections(s.selections, variables, defaults, fragments),
                )
            )
    return out


def parse_query(src: str, variables: Optional[dict[str, Any]] = None) -> Operation:
    """Parse + resolve variables/fragments -> a plain Operation whose arg
    values are Python literals (EnumValue for enum tokens)."""
    doc = _Parser(_tokenize(src), variables or {}).parse_document()
    op = doc.operation
    op.selections = _resolve_selections(
        op.selections, variables or {}, op.variable_defaults, doc.fragments
    )
    return op
