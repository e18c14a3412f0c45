"""Cluster topology: name -> node map with layer ranges (counterpart of
cake_tpu/cluster/topology.py).

YAML format, with the `model.layers.a-b` range syntax (`layers: []`
leaves a node's range unset):

    worker-a:
      host: 10.0.0.2:10128
      layers: ["model.layers.0-13"]
      memory_bytes: 17179869184     # optional capability overrides
      tflops: 394.0
      backend: cuda

The reference reads the file with PyYAML, which the card's machine lacks.
`load_yaml` reads the subset this format uses and gives what
`yaml.safe_load` gives for it: block maps of block maps, plain and quoted
scalars (ints, floats, true/false, null, strings), and lists, in flow
form (`[a, "b", 3]`) or as block items (`- a`). Anything outside that
subset (anchors, tags, multi-line strings, flow maps, nested lists, a
tab, or a plain scalar that YAML 1.1 would read as something else, such
as `yes`, `0x10`, `010` or `1:30`) raises ValueError instead of being
guessed at.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

_RANGE_RE = re.compile(r"^(?:model\.)?layers\.(\d+)(?:-(\d+))?$")


@dataclass
class Node:
    name: str
    host: str                      # "ip:port"
    layers: list[int] = field(default_factory=list)
    memory_bytes: int = 0
    tflops: float = 0.0
    backend: str = ""
    hostname: str = ""
    os: str = ""

    @property
    def layer_range(self) -> tuple[int, int] | None:
        if not self.layers:
            return None
        lo, hi = min(self.layers), max(self.layers)
        if sorted(self.layers) != list(range(lo, hi + 1)):
            raise ValueError(f"{self.name}: non-contiguous layers {self.layers}")
        return lo, hi + 1

    @property
    def addr(self) -> tuple[str, int]:
        host, _, port = self.host.partition(":")
        return host, int(port or 10128)


def expand_layer_specs(specs: list) -> list[int]:
    """["model.layers.0-5", "layers.7"] -> [0, 1, 2, 3, 4, 5, 7]."""
    out: list[int] = []
    for s in specs:
        if isinstance(s, int):
            out.append(s)
            continue
        m = _RANGE_RE.match(str(s).strip())
        if not m:
            raise ValueError(f"bad layer spec {s!r}")
        lo = int(m.group(1))
        hi = int(m.group(2)) if m.group(2) else lo
        if hi < lo:
            raise ValueError(f"descending layer range {s!r}")
        out.extend(range(lo, hi + 1))
    return out


class Topology:
    def __init__(self, nodes: dict[str, Node] | None = None):
        self.nodes: dict[str, Node] = nodes or {}

    @classmethod
    def from_dict(cls, d: dict) -> "Topology":
        nodes = {}
        for name, spec in (d or {}).items():
            nodes[name] = Node(
                name=name,
                host=str(spec.get("host", "")),
                layers=expand_layer_specs(spec.get("layers", []) or []),
                memory_bytes=int(spec.get("memory_bytes",
                                          spec.get("vram_bytes", 0)) or 0),
                tflops=float(spec.get("tflops", 0.0) or 0.0),
                backend=str(spec.get("backend", "")),
                hostname=str(spec.get("hostname", "")),
                os=str(spec.get("os", "")),
            )
        return cls(nodes)

    @classmethod
    def from_path(cls, path: str) -> "Topology":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(load_yaml(f.read()) or {})

    def to_dict(self) -> dict:
        out = {}
        for name, n in self.nodes.items():
            lr = n.layer_range
            out[name] = {
                "host": n.host,
                "layers": ([f"model.layers.{lr[0]}-{lr[1] - 1}"] if lr else []),
                "memory_bytes": n.memory_bytes,
                "tflops": n.tflops,
                "backend": n.backend,
            }
        return out

    def assigned_layers(self) -> set[int]:
        out: set[int] = set()
        for n in self.nodes.values():
            overlap = out & set(n.layers)
            if overlap:
                raise ValueError(f"layer(s) {sorted(overlap)} assigned twice")
            out |= set(n.layers)
        return out


# -- the YAML subset ----------------------------------------------------------

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")
# plain scalars YAML 1.1 (PyYAML) reads as something the subset does not
# take: other bools, octal / hex / binary / underscored / sexagesimal
# numbers, .inf / .nan, leading-dot floats, dates
_AMBIGUOUS = re.compile(
    r"(?:y|Y|yes|Yes|YES|n|N|no|No|NO|on|On|ON|off|Off|OFF|=|<<)"
    r"|[-+]?0[0-7_]+|[-+]?0[bxo].*|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+.*"
    r"|[-+]?[0-9][0-9_]*_[0-9_]*(?:\.[0-9_]*)?.*|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN)|[-+]?\.[0-9_]+.*|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*")
_NULLS = ("", "~", "null", "Null", "NULL")
_BOOLS = {"true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False}


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at the start or after a space,
    outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str, where: int):
    t = text.strip()
    if not t:
        return None
    if t[0] in "\"'":
        q = t[0]
        if len(t) < 2 or t[-1] != q:
            raise ValueError(f"line {where}: unterminated quoted scalar {t!r}")
        body = t[1:-1]
        if q == "'":
            if re.search(r"(?<!')'(?!')", body):
                raise ValueError(f"line {where}: bad quoted scalar {t!r}")
            return body.replace("''", "'")
        if "\\" in body or '"' in body:
            raise ValueError(f"line {where}: escapes in {t!r} are outside "
                             "the YAML subset")
        return body
    if t[0] in "&*!|>%@`{[]},?-" and not _INT.fullmatch(t) \
            and not _FLOAT.fullmatch(t):
        raise ValueError(f"line {where}: {t!r} is outside the YAML subset")
    if ": " in t or t.endswith(":") or " #" in t:
        raise ValueError(f"line {where}: {t!r} is outside the YAML subset")
    if t in _NULLS:
        return None
    if t in _BOOLS:
        return _BOOLS[t]
    if _INT.fullmatch(t):
        return int(t)
    if _FLOAT.fullmatch(t):
        return float(t)
    if _AMBIGUOUS.fullmatch(t):
        raise ValueError(f"line {where}: plain scalar {t!r} is read by YAML "
                         "1.1 as something else; quote it")
    return t


def _flow_list(text: str, where: int) -> list:
    t = text.strip()
    if not (t.startswith("[") and t.endswith("]")):
        raise ValueError(f"line {where}: {t!r} is outside the YAML subset")
    body = t[1:-1].strip()
    if not body:
        return []
    items, cur, quote = [], "", None
    for c in body:
        if quote:
            cur += c
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
            cur += c
        elif c in "[]{}":
            raise ValueError(f"line {where}: nested flow collections are "
                             "outside the YAML subset")
        elif c == ",":
            items.append(cur)
            cur = ""
        else:
            cur += c
    if quote:
        raise ValueError(f"line {where}: unterminated quote in {t!r}")
    if cur.strip() or not items:
        items.append(cur)
    if any(not i.strip() for i in items):
        raise ValueError(f"line {where}: empty flow list item in {t!r}")
    return [_scalar(i, where) for i in items]


def _value(text: str, where: int):
    t = text.strip()
    if t.startswith("["):
        return _flow_list(t, where)
    return _scalar(t, where)


def _key(text: str, where: int) -> str:
    k = _scalar(text, where)
    if not isinstance(k, (str, int)) or isinstance(k, bool):
        raise ValueError(f"line {where}: key {text!r} is outside the YAML "
                         "subset")
    return k


def load_yaml(text: str):
    """yaml.safe_load of the topology subset (see the module doc)."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: a tab in the indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "...") or line.startswith("%"):
            raise ValueError(f"line {n}: document markers and directives "
                             "are outside the YAML subset")
        lines.append((n, len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][1])
    if i != len(lines):
        raise ValueError(f"line {lines[i][0]}: unexpected indentation")
    return value


def _block(lines, i: int, indent: int):
    """The block (map or list) whose lines start at i with `indent`;
    returns (value, next line index)."""
    n, ind, text = lines[i]
    if ind != indent:
        raise ValueError(f"line {n}: unexpected indentation")
    if text == "-" or text.startswith("- "):
        out = []
        while i < len(lines) and lines[i][1] == indent:
            n, _, text = lines[i]
            if not (text == "-" or text.startswith("- ")):
                break           # the list sat at its key's indentation
            item = text[1:].strip()
            if item.startswith("- ") or item == "-" or (
                    ": " in item or item.endswith(":")) and item[0] not in "\"'":
                raise ValueError(f"line {n}: nested collections in a block "
                                 "list are outside the YAML subset")
            out.append(_value(item, n))
            i += 1
        return out, i
    out = {}
    while i < len(lines) and lines[i][1] == indent:
        n, _, text = lines[i]
        if text.startswith("- ") or text == "-":
            raise ValueError(f"line {n}: a list item among map keys")
        m = re.match(r"^((?:\"[^\"]*\"|'[^']*'|[^:'\"])+?):(?: (.*))?$", text)
        if not m:
            raise ValueError(f"line {n}: {text!r} is not `key: value`")
        key = _key(m.group(1), n)
        if key in out:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        rest = (m.group(2) or "").strip()
        i += 1
        if rest:
            out[key] = _value(rest, n)
        elif i < len(lines) and lines[i][1] > indent:
            out[key], i = _block(lines, i, lines[i][1])
        elif (i < len(lines) and lines[i][1] == indent
              and lines[i][2].startswith("- ")):
            # a block list may sit at its key's own indentation
            out[key], i = _block(lines, i, indent)
        else:
            out[key] = None
    if i < len(lines) and lines[i][1] > indent:
        raise ValueError(f"line {lines[i][0]}: unexpected indentation")
    return out, i
