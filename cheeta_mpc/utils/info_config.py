"""Boost property-tree ``.info`` file ingestion.

The reference's entire config layer is Boost ``.info`` files parsed by
``loadData::loadPtreeValue/loadEigenMatrix/loadStdVector`` (SURVEY.md §5):
``task.info``, ``gait.info``, ``reference.info``. This parser reads the same
files verbatim into nested dicts, with helpers for the reference's matrix
literals ``(i,j) value`` and indexed lists ``[i] value``.

Grammar handled (sufficient for all shipped configs):
    key value            ; or // comment
    section { ... }      (brace on same or next line)
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np


def _strip_comment(line: str) -> str:
    for marker in (';', '//'):
        pos = line.find(marker)
        if pos >= 0:
            line = line[:pos]
    return line.strip()


def _tokenize(text: str) -> List[str]:
    tokens: List[str] = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line:
            continue
        # Separate braces into their own tokens.
        line = line.replace('{', ' { ').replace('}', ' } ')
        tokens.extend(line.split())
    return tokens


def _coerce(value: str) -> Any:
    if value.lower() == 'true':
        return True
    if value.lower() == 'false':
        return False
    try:
        iv = int(value)
        return iv
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        return value


def parse_info(text: str) -> Dict[str, Any]:
    """Parse .info text into nested dicts (duplicate keys keep the last)."""
    tokens = _tokenize(text)
    pos = 0

    def parse_block() -> Dict[str, Any]:
        nonlocal pos
        out: Dict[str, Any] = {}
        while pos < len(tokens):
            tok = tokens[pos]
            if tok == '}':
                pos += 1
                return out
            key = tok
            pos += 1
            if pos < len(tokens) and tokens[pos] == '{':
                pos += 1
                out[key] = parse_block()
            else:
                # value tokens until next key... values are single tokens in
                # the shipped configs.
                value = tokens[pos] if pos < len(tokens) else ''
                pos += 1
                if pos < len(tokens) and tokens[pos] == '{':
                    # "key value {" does not occur; treat value as key of block
                    pos += 1
                    out[key] = parse_block()
                else:
                    out[key] = _coerce(value)
        return out

    return parse_block()


def load_info(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return parse_info(f.read())


_MAT_KEY = re.compile(r'^\((\d+),(\d+)\)$')
_LIST_KEY = re.compile(r'^\[(\d+)\]$')


def as_matrix(block: Dict[str, Any]) -> np.ndarray:
    """Convert a ``(i,j) value`` block (reference loadEigenMatrix literals,
    e.g. task.info initialState/Q/R) into a dense array, honoring the
    optional ``scaling`` entry the reference loader supports. Column vectors
    (all j==0) are returned 1-D."""
    entries = []
    scaling = 1.0
    for key, val in block.items():
        if key == 'scaling':
            scaling = float(val)
            continue
        mk = _MAT_KEY.match(key)
        if not mk:
            raise ValueError(f"not a matrix entry: {key}")
        entries.append((int(mk.group(1)), int(mk.group(2)), float(val)))
    rows = max(e[0] for e in entries) + 1
    cols = max(e[1] for e in entries) + 1
    M = np.zeros((rows, cols))
    for i, j, v in entries:
        M[i, j] = v
    M *= scaling
    return M[:, 0] if cols == 1 else M


def as_list(block: Dict[str, Any]) -> List[Any]:
    """Convert an ``[i] value`` block (reference loadStdVector, e.g.
    gait.info modeSequence/switchingTimes) into an ordered list."""
    items = []
    for key, val in block.items():
        lk = _LIST_KEY.match(key)
        if not lk:
            raise ValueError(f"not a list entry: {key}")
        items.append((int(lk.group(1)), val))
    return [v for _, v in sorted(items)]


def load_gait_library(path: str):
    """Parse the reference gait.info into {name: ModeSequenceTemplate}
    (reference GaitKeyboardPublisher.cpp:51-58 + ModeSequenceTemplate
    loader)."""
    from cheeta_mpc.gait.motion_phase import mode_from_name
    from cheeta_mpc.gait.schedule import ModeSequenceTemplate

    tree = load_info(path)
    names = [str(n) for n in as_list(tree['list'])]
    library = {}
    for name in names:
        block = tree[name]
        modes = [mode_from_name(str(m)) for m in as_list(block['modeSequence'])]
        times = [float(t) for t in as_list(block['switchingTimes'])]
        library[name] = ModeSequenceTemplate(switching_times=times,
                                             mode_sequence=modes)
    return library
