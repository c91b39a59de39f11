"""Minimal dataclass-driven CLI (draccus-style `--field value` parsing).

The reference wraps every entry point in `@draccus.wrap()` over a config
dataclass (e.g. `FinetuneConfig`, finetune.py:79-131). draccus is not in this
environment, so this module provides the same ergonomics: every dataclass
field becomes a `--name` flag with type coercion (bool/int/float/str/enum/
Optional/Path), so reference command lines port over unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
import sys
import typing
from pathlib import Path
from typing import Any, Callable, Optional, Sequence, Type, TypeVar

T = TypeVar("T")


def _coerce(value: str, ty: Any) -> Any:
    origin = typing.get_origin(ty)
    if origin is typing.Union:
        args = [a for a in typing.get_args(ty) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        return _coerce(value, args[0])
    if ty is bool or ty == "bool":
        return value.lower() in ("1", "true", "yes", "y", "t")
    if ty is int:
        return int(value)
    if ty is float:
        return float(value)
    if ty is Path:
        return Path(value)
    if isinstance(ty, type) and issubclass(ty, enum.Enum):
        try:
            return ty(value)
        except ValueError:
            return ty[value]
    import collections.abc

    # get_origin(Sequence[int]) is collections.abc.Sequence, not typing.Sequence
    if origin in (list, tuple, Sequence, collections.abc.Sequence):
        inner = typing.get_args(ty)[0] if typing.get_args(ty) else str
        items = [x for x in value.strip("[]() ").split(",") if x]
        seq = [(_coerce(x.strip(), inner)) for x in items]
        return tuple(seq) if origin is tuple else seq
    return value


def _is_bool(ty: Any) -> bool:
    if typing.get_origin(ty) is typing.Union:
        args = [a for a in typing.get_args(ty) if a is not type(None)]
        return len(args) == 1 and _is_bool(args[0])
    return ty is bool or ty == "bool"


def parse_args(config_cls: Type[T], argv: Optional[Sequence[str]] = None) -> T:
    """`--name value` (or `--name=value`) per field, dashes or underscores.
    A bool field also takes a bare `--name` (True) and `--no-name` (False)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    fields = {f.name: f for f in dataclasses.fields(config_cls)}
    hints = typing.get_type_hints(config_cls)
    overrides = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected positional argument {arg!r}")
        if "=" in arg:
            name, value = arg[2:].split("=", 1)
            name = name.replace("-", "_")
            i += 1
        else:
            name = arg[2:].replace("-", "_")
            if name in ("help", "h"):
                _print_help(config_cls)
                raise SystemExit(0)
            bare = i + 1 >= len(argv) or argv[i + 1].startswith("--")
            if bare and name in fields and _is_bool(hints.get(name)):
                value = "true"
                i += 1
            elif bare and name.startswith("no_") and name not in fields \
                    and _is_bool(hints.get(name[3:])):
                name, value = name[3:], "false"
                i += 1
            elif i + 1 >= len(argv):
                raise SystemExit(f"missing value for --{name}")
            else:
                value = argv[i + 1]
                i += 2
        if name in ("help", "h"):
            _print_help(config_cls)
            raise SystemExit(0)
        if name not in fields:
            raise SystemExit(
                f"unknown flag --{name}; valid: {', '.join(sorted(fields))}")
        overrides[name] = _coerce(value, hints.get(name, str))
    return config_cls(**overrides)


def _print_help(config_cls) -> None:
    print(f"usage: --field value ...   ({config_cls.__name__})")
    for f in dataclasses.fields(config_cls):
        default = f.default if f.default is not dataclasses.MISSING else \
            (f.default_factory() if f.default_factory is not dataclasses.MISSING
             else "<required>")
        print(f"  --{f.name:<32} (default: {default})")


def wrap(config_cls: Type[T]) -> Callable:
    """Decorator: `@wrap(Config)` over `main(cfg)` parses argv -> Config."""

    def deco(fn):
        def runner():
            return fn(parse_args(config_cls))

        return runner

    return deco
