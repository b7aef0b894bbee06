"""Prompt-template registry.

Each template is a list of callables ``classname -> prompt string``, matching
the registry the reference exposes via ``getattr(src.templates, name)``
(`src/templates/__init__.py`).  Prompt strings are public
data from the CLIP/FLYP releases and are preserved verbatim.
"""

from __future__ import annotations

from .registry import (
    get_template,
    register_template,
    TEMPLATES,
    get_plural,
    append_proper_article,
)
from .prompts import *  # noqa: F401,F403 — populates the registry

from .prompts import __all__ as _prompt_names

__all__ = [
    "get_template",
    "register_template",
    "TEMPLATES",
    "get_plural",
    "append_proper_article",
] + list(_prompt_names)
