"""Three-tier configuration: dataclass defaults < environment < CLI.

Counterpart of ``tpu_patterns/core/config.py``, the same code: every
pattern's config is a dataclass; defaults are field defaults, the
environment tier reads ``TPU_PATTERNS_<FIELD>``, and the CLI tier is one
argparse flag per field.

Two keyword arguments of :func:`add_config_args` are the port's own:
``choices`` adds the choices of fields whose dataclass carries none in
its metadata, and ``coerce`` replaces :func:`_coerce` for the flags and
the environment tier (``tpu_patterns_torch/cli.py`` passes one that
refuses a word that is no boolean, where :func:`_coerce` reads it as
False, as the reference does).  An environment value that cannot be
coerced, or is not one of its field's choices, raises a ``ValueError``
that names its variable (argparse checks no default against its
choices).
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import os
import types
import typing
from typing import Any, Callable, Mapping, Sequence

ENV_PREFIX = "TPU_PATTERNS_"


def _coerce(field_type: Any, raw: str) -> Any:
    """Coerce a string (env var / CLI token) to a dataclass field type."""
    origin = typing.get_origin(field_type)
    if origin is typing.Union or origin is types.UnionType:  # Optional[T] / T | None
        args = [a for a in typing.get_args(field_type) if a is not type(None)]
        if not raw or raw.lower() == "none":
            return None
        return _coerce(args[0], raw)
    if origin in (list, tuple):
        (elem,) = typing.get_args(field_type)[:1] or (str,)
        items = [_coerce(elem, tok) for tok in raw.split(",") if tok != ""]
        return tuple(items) if origin is tuple else items
    if isinstance(field_type, type) and issubclass(field_type, enum.Enum):
        try:
            return field_type[raw.upper().replace("-", "_")]
        except KeyError:
            return field_type(raw)
    if field_type is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return field_type(raw)


def _env_value(name: str, env: Mapping[str, str]) -> str | None:
    return env.get(ENV_PREFIX + name.upper())


def add_config_args(
    parser: argparse.ArgumentParser,
    cls: type,
    env: Mapping[str, str] | None = None,
    skip: Sequence[str] = (),
    *,
    choices: Mapping[str, Sequence[str]] | None = None,
    coerce: Callable[[Any, str], Any] = _coerce,
) -> None:
    """Add one ``--<field>`` flag per dataclass field.

    The flag default is the env-tier value when set, else the field default,
    so precedence after ``parser.parse_args`` is CLI > env > default.
    ``skip`` names fields the caller wires up manually (e.g. repeatable
    flags that don't fit the one-token-per-field scheme).  ``choices``
    gives a field's choices where its metadata has none; ``coerce(type,
    raw)`` turns a flag's or the environment's string into the field's
    type.
    """
    env = os.environ if env is None else env
    choices = choices or {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if not f.init or f.name in skip:
            continue
        ftype = hints[f.name]
        default = (
            f.default
            if f.default is not dataclasses.MISSING
            else f.default_factory()  # type: ignore[misc]
        )
        allowed = f.metadata.get("choices", choices.get(f.name))
        raw = _env_value(f.name, env)
        if raw is not None:
            var = f"{ENV_PREFIX}{f.name.upper()}={raw!r}"
            try:
                default = coerce(ftype, raw)
            except (ValueError, argparse.ArgumentTypeError) as e:
                raise ValueError(f"{var}: {e}") from e
            if allowed is not None and default not in allowed:
                raise ValueError(f"{var}: not one of {tuple(allowed)}")
        flag = "--" + f.name
        help_text = f.metadata.get("help", "")
        if ftype is bool:
            parser.add_argument(
                flag,
                type=lambda s: coerce(bool, s),
                default=default,
                metavar="BOOL",
                help=f"{help_text} (default: {default})",
            )
        elif typing.get_origin(ftype) in (list, tuple):
            parser.add_argument(
                flag,
                type=str,
                default=default,
                metavar="A,B,...",
                help=f"{help_text} (comma separated; default: {default})",
            )
        else:
            conv = lambda s, t=ftype: coerce(t, s)  # noqa: E731
            conv.__name__ = getattr(ftype, "__name__", str(ftype))
            parser.add_argument(
                flag,
                type=conv,
                default=default,
                choices=allowed,
                help=f"{help_text} (default: {default})",
            )


def config_from_tiers(
    cls: type,
    argv: Sequence[str] | None = None,
    env: Mapping[str, str] | None = None,
    **overrides: Any,
):
    """Build ``cls`` from default < env < CLI(argv) < explicit overrides."""
    parser = argparse.ArgumentParser(prog=cls.__name__, add_help=False)
    add_config_args(parser, cls, env=env)
    ns, _unknown = parser.parse_known_args(list(argv) if argv is not None else [])
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        val = getattr(ns, f.name)
        if isinstance(val, str) and typing.get_origin(hints[f.name]) in (list, tuple):
            val = _coerce(hints[f.name], val)
        kwargs[f.name] = val
    kwargs.update(overrides)
    return cls(**kwargs)


def config_to_dict(cfg: Any) -> dict[str, Any]:
    """JSON-friendly dict of a config dataclass (enums -> names)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = v.name.lower()
        elif isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out
