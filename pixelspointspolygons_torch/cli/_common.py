"""Command-line parsing shared by the port's entry points: hydra-style
`key.path=value` overrides go to the config engine; `device=cpu` (or any
torch device) picks the device, which is the card when it is not given."""

from __future__ import annotations

import sys

from ..config.engine import Config, compose


def compose_from_argv(argv: list[str] | None = None) -> tuple[Config, str | None]:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    overrides = []
    for a in argv:
        if a.startswith("device="):
            device = a.split("=", 1)[1]
        else:
            overrides.append(a)
    return compose(overrides), device


def format_results(results: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v) for k, v in results.items()}
