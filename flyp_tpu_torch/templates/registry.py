"""Template registry and prompt helpers.

Reproduces the reference's name-keyed template lookup
(`src/templates/__init__.py:1-14`, resolved via
``getattr(src.templates, args.template)`` at
`src/models/zeroshot.py:23`) and the pluralize/article
helpers (`src/templates/utils.py:2-29`)."""

from __future__ import annotations

from typing import Callable, Dict, List

TemplateFn = Callable[[str], str]
TEMPLATES: Dict[str, List[TemplateFn]] = {}


def register_template(name: str, template: List[TemplateFn]) -> List[TemplateFn]:
    TEMPLATES[name] = template
    return template


def get_template(name: str) -> List[TemplateFn]:
    if name not in TEMPLATES:
        raise KeyError(f"unknown template {name!r}; known: {sorted(TEMPLATES)}")
    return TEMPLATES[name]


def fmt(pattern: str) -> TemplateFn:
    """Build a template callable from a '{}'-style pattern."""
    return lambda c: pattern.format(c)


def get_plural(name: str) -> str:
    """English pluralization heuristic (`src/templates/utils.py:2-22`)."""
    name = name.replace("_", " ")
    if name[-2:] in ("sh", "ch"):
        return name + "es"
    if name[-1:] == "y":
        return name[:-1] + "ies"
    if name[-1:] in ("s", "x"):
        return name + "es"
    if name[-3:] == "man":
        return name[:-3] + "men"
    if name == "mouse":
        return "mice"
    if name[-1:] == "f":
        return name[:-1] + "ves"
    return name + "s"


def append_proper_article(name: str) -> str:
    name = name.replace("_", " ")
    return ("an " if name[0] in "aeiou" else "a ") + name
