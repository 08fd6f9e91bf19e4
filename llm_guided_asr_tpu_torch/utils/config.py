"""Config helpers (counterpart of llm_guided_asr_tpu/utils/config.py, the
parts the port needs: token lists, conf-dict filtering and data triples)."""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import List, Sequence, Union

logger = logging.getLogger(__name__)


def read_token_list(token_list: Union[str, Path, Sequence[str]]) -> List[str]:
    """A token-list file (one token a line, blank lines skipped) or a
    sequence of tokens -> list of tokens."""
    if isinstance(token_list, (str, Path)):
        with open(token_list, encoding="utf-8") as f:
            return [line.rstrip("\n") for line in f if line.rstrip("\n") != ""]
    return list(token_list)


def filter_known_fields(cls, d: dict, where: str = "") -> dict:
    """The keys of ``d`` that are fields of the dataclass ``cls``; the rest
    are dropped with a warning that names them (a mistyped component-conf
    key must not vanish silently)."""
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(k for k in d if k not in known)
    if unknown:
        logger.warning(f"ignoring unknown {where or cls.__name__} key(s): {unknown} "
                       f"(known: {sorted(known)})")
    return {k: v for k, v in d.items() if k in known}


def normalize_triples(value) -> List[tuple]:
    """data_path_and_name_and_type entries -> [(path, name, type), ...].

    Accepts YAML lists of 3-lists and the reference's CLI form
    'path,name,type' (possibly a single string or a list of strings)."""
    if value is None:
        return []
    if isinstance(value, str):
        value = [value]
    out = []
    for item in value:
        if isinstance(item, str):
            parts = item.split(",")
            if len(parts) != 3:
                raise ValueError(f"expected 'path,name,type', got {item!r}")
            out.append(tuple(p.strip() for p in parts))
        else:
            t = tuple(item)
            if len(t) != 3:
                raise ValueError(f"expected a (path, name, type) triple, got {item!r}")
            out.append(t)
    return out
