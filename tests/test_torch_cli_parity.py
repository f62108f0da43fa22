"""The port's command line against the JAX package's: every subcommand of
the JAX ``build_parser()`` exists in the port's, with the same flags, and
each flag with the same default, choices, nargs, constant, type, action and
whether it is required. The port's named additions are exempt: ``--device``
on every subcommand that runs a model, and ``--compute_dtype`` and
``--logging_steps`` on distill and finetune."""

import argparse

import pytest

from taiwan_whisper_tpu import cli as jax_cli
from taiwan_whisper_tpu_torch import cli as port_cli

PORT_ADDITIONS = {"--device", "--compute_dtype", "--logging_steps"}


def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _flags(sub):
    """Each option's attributes that a caller can observe, by its first
    option string; the type by name (each CLI defines its own parser
    functions)."""
    out = {}
    for a in sub._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        typ = getattr(a.type, "__name__", a.type)
        out[a.option_strings[0] if a.option_strings else a.dest] = dict(
            options=tuple(a.option_strings), dest=a.dest, default=a.default,
            choices=None if a.choices is None else list(a.choices), nargs=a.nargs,
            const=a.const, type=typ, action=type(a).__name__, required=a.required)
    return out


JAX_SUBS = _subparsers(jax_cli.build_parser())
PORT_SUBS = _subparsers(port_cli.build_parser())


def test_port_has_every_jax_subcommand():
    assert set(JAX_SUBS) <= set(PORT_SUBS)
    assert set(PORT_SUBS) == set(JAX_SUBS)  # and nothing the JAX CLI lacks
    assert port_cli.build_parser().fromfile_prefix_chars == \
        jax_cli.build_parser().fromfile_prefix_chars == "@"


@pytest.mark.parametrize("name", sorted(JAX_SUBS))
def test_subcommand_flags_match_jax(name):
    ref, got = _flags(JAX_SUBS[name]), _flags(PORT_SUBS[name])
    extra = set(got) - set(ref)
    assert extra <= PORT_ADDITIONS, f"{name}: flags the JAX CLI lacks: {extra - PORT_ADDITIONS}"
    assert set(ref) <= set(got), f"{name}: missing {set(ref) - set(got)}"
    for flag, attrs in ref.items():
        assert got[flag] == attrs, flag
    if "--device" in got:
        assert got["--device"]["default"] is None  # cuda unless the caller names another
    if "--compute_dtype" in got:
        assert name in ("distill", "finetune") and got["--compute_dtype"]["default"] == "bf16"
