"""Config helpers (counterpart of llm_guided_asr_tpu/utils/config.py, the
parts the port needs: token lists and conf-dict filtering)."""

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
