"""Text-format protobuf (deploy.prototxt) parser — stdlib only.

The port's copy of real_time_video_deepfake_detection_tpu/utils/prototxt.py.

Parses Caffe's prototxt into nested Python dicts:
  message fields -> dict entries; repeated fields -> lists;
  `layer { ... }` blocks -> cfg["layer"] = [dict, ...].
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_TOKEN = re.compile(r"""
    \s*(?:
        (?P<comment>\#[^\n]*)
      | (?P<brace_open>\{)
      | (?P<brace_close>\})
      | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<colon>:)
      | (?P<string>"(?:[^"\\]|\\.)*")
      | (?P<number>-?[0-9]+(?:\.[0-9]+)?(?:[eE][-+]?[0-9]+)?)
    )""", re.VERBOSE)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            if text[pos].isspace():
                pos += 1
                continue
            raise ValueError(f"prototxt parse error at {pos}: {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "comment" or kind is None:
            continue
        yield kind, m.group(kind)


def _convert(value: str):
    if value.startswith('"'):
        return value[1:-1]
    if value in ("true", "false"):
        return value == "true"
    try:
        if re.fullmatch(r"-?[0-9]+", value):
            return int(value)
        return float(value)
    except ValueError:
        return value


def parse_prototxt(text: str) -> Dict[str, Any]:
    tokens = list(_tokenize(text))
    pos = 0

    def parse_block() -> Dict[str, Any]:
        nonlocal pos
        out: Dict[str, Any] = {}

        def add(key, val):
            if key in out:
                if not isinstance(out[key], list):
                    out[key] = [out[key]]
                out[key].append(val)
            else:
                out[key] = val

        while pos < len(tokens):
            kind, val = tokens[pos]
            if kind == "brace_close":
                pos += 1
                return out
            assert kind == "name", (kind, val)
            key = val
            pos += 1
            kind2, val2 = tokens[pos]
            if kind2 == "colon":
                pos += 1
                kind3, val3 = tokens[pos]
                pos += 1
                if kind3 == "name":   # enum value or bare bool
                    if val3 in ("true", "false"):
                        add(key, val3 == "true")
                    else:
                        add(key, val3)
                else:
                    add(key, _convert(val3))
            elif kind2 == "brace_open":
                pos += 1
                add(key, parse_block())
            else:
                raise ValueError(f"unexpected token {kind2} after {key}")
        return out

    return parse_block()


def load_prototxt(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return parse_prototxt(f.read())


def as_list(x) -> List:
    if x is None:
        return []
    return x if isinstance(x, list) else [x]
