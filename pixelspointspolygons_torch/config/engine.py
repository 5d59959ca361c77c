"""Self-contained config engine: a clean-room mini Hydra/OmegaConf — the
port's own copy of pixelspointspolygons_tpu/config/engine.py, reading the
same repo-root ``config/`` tree.

Reproduces the composition semantics the reference relies on
(reference: config/config.yaml defaults list; pixelspointspolygons/misc/shared_utils.py:28-35
registers the custom resolvers ``eq``/``if``/``divide``):

- a YAML group tree rooted at ``config.yaml`` with a ``defaults:`` list,
- group entries loaded *relative to the containing group node* (so
  ``- /dataset: p3`` inside ``experiment/default.yaml`` lands at
  ``cfg.experiment.dataset``),
- ``_self_`` controlling when the file's own keys merge,
- ``${path}`` absolute and ``${.x}`` / ``${..x}`` relative interpolation,
- resolvers ``${eq:a,b}``, ``${if:cond,a,b}``, ``${divide:a,b}``, ``${mult:a,b}``,
- CLI overrides: ``group=option``, ``key.path=value``, ``+key.path=value``,
  ``~key`` deletion.

The composed result is a mutable attribute-access :class:`Config` tree
(the reference mutates cfg at runtime, e.g. tokenizer.py:25-27 writes
``pad_idx``/``max_len``/``generation_steps`` back into cfg — we support that).
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Iterable

import yaml

__all__ = ["Config", "compose", "load_yaml", "default_config_dir"]


def default_config_dir() -> str:
    """Repo-root ``config/`` directory (the public config tree)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "config"))


class Config(dict):
    """Nested dict with attribute access. Mutable after composition."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                return default
        return node

    @staticmethod
    def from_dict(d: Any) -> Any:
        if isinstance(d, dict):
            return Config({k: Config.from_dict(v) for k, v in d.items()})
        if isinstance(d, (list, tuple)):
            return [Config.from_dict(v) for v in d]
        return d

    def to_dict(self) -> dict:
        def conv(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return conv(self)


def load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        out = yaml.safe_load(f)
    return out or {}


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------


def _deep_merge(base: dict, overlay: dict) -> dict:
    """Merge overlay into base (overlay wins; dicts merge recursively)."""
    for k, v in overlay.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            _deep_merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


def _set_path(tree: dict, path: str, value: Any) -> None:
    parts = path.split(".")
    node = tree
    for p in parts[:-1]:
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            node[p] = nxt
        node = nxt
    if isinstance(value, dict) and isinstance(node.get(parts[-1]), dict):
        _deep_merge(node[parts[-1]], value)
    else:
        node[parts[-1]] = value


def _del_path(tree: dict, path: str) -> None:
    parts = path.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.get(p, {})
        if not isinstance(node, dict):
            return
    node.pop(parts[-1], None)


def _load_group_file(config_dir: str, group: str, option: str) -> dict:
    path = os.path.join(config_dir, *group.split("/"), f"{option}.yaml")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"Config group file not found: {path} (group={group!r}, option={option!r})"
        )
    return load_yaml(path)


def _compose_file(
    config_dir: str,
    raw: dict,
    group_overrides: dict,
    prefix: str,
) -> dict:
    """Compose one YAML file: process its defaults list, then its own keys.

    ``prefix`` is the dotted path of the node this file populates ('' = root).
    Group selections can be overridden from the CLI via ``group_overrides``
    keyed by the group's full path relative to root.
    """
    raw = copy.deepcopy(raw)
    defaults: Iterable = raw.pop("defaults", [])
    own = raw

    result: dict = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            _deep_merge(result, own)
            self_merged = True
            continue
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ValueError(f"Unsupported defaults entry: {entry!r}")
        (group, option), = entry.items()
        group = str(group)
        # '/dataset' inside a group file = group path relative to the
        # *containing node* (hydra packages it at <prefix>.<group>).
        group_rel = group.lstrip("/")
        full_path = f"{prefix}.{group_rel}" if prefix else group_rel
        full_path = full_path.replace("/", ".")
        # overrides may target the node path ('experiment.dataset') or, like
        # hydra, the group directory ('dataset')
        option = group_overrides.get(
            full_path, group_overrides.get(group_rel.replace("/", "."), option)
        )
        if option is None:
            continue
        sub_raw = _load_group_file(config_dir, group_rel, str(option))
        sub = _compose_file(config_dir, sub_raw, group_overrides, full_path)
        _set_path(result, group_rel.replace("/", "."), sub)
    if not self_merged:
        _deep_merge(result, own)
    return result


_GROUP_RE = re.compile(r"^[A-Za-z_][\w/]*$")


def compose(
    overrides: Iterable[str] | None = None,
    config_dir: str | None = None,
    config_name: str = "config",
) -> Config:
    """Compose the config tree, apply CLI-style overrides, resolve interpolations."""
    config_dir = config_dir or default_config_dir()
    overrides = list(overrides or [])

    group_overrides: dict[str, str] = {}
    kv_overrides: list[tuple[str, str, Any]] = []  # (mode, path, value)

    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith("~"):
            kv_overrides.append(("del", ov[1:], None))
            continue
        mode = "set"
        if ov.startswith("+"):
            mode = "add"
            ov = ov[1:]
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        key = key.strip()
        parsed = yaml.safe_load(val) if val != "" else None
        # A bare group name with a plain-word value that names a group file
        # is a group override (e.g. 'experiment=p2p_fusion').
        is_group_dir = _GROUP_RE.match(key) and os.path.isdir(
            os.path.join(config_dir, *key.replace(".", "/").split("/"))
        )
        if mode == "set" and is_group_dir:
            if not (
                isinstance(parsed, str)
                and os.path.isfile(
                    os.path.join(
                        config_dir, *key.replace(".", "/").split("/"), f"{parsed}.yaml"
                    )
                )
            ):
                avail = sorted(
                    f[:-5]
                    for f in os.listdir(
                        os.path.join(config_dir, *key.replace(".", "/").split("/"))
                    )
                    if f.endswith(".yaml")
                )
                raise ValueError(
                    f"Unknown option {parsed!r} for config group {key!r}; "
                    f"available: {avail}"
                )
            group_overrides[key.replace("/", ".")] = parsed
        else:
            kv_overrides.append((mode, key, parsed))

    root_raw = load_yaml(os.path.join(config_dir, f"{config_name}.yaml"))
    tree = _compose_file(config_dir, root_raw, group_overrides, "")

    for mode, path, value in kv_overrides:
        if mode == "del":
            _del_path(tree, path)
        else:
            _set_path(tree, path, value)

    tree = _resolve_tree(tree)
    return Config.from_dict(tree)


# ---------------------------------------------------------------------------
# Interpolation resolution
# ---------------------------------------------------------------------------

_MAX_PASSES = 20


def _find_interp(s: str) -> tuple[int, int] | None:
    """Find the first innermost ``${...}`` span (no nested '${' inside)."""
    start = s.find("${")
    if start < 0:
        return None
    i = start + 2
    depth = 1
    inner_start = start
    while i < len(s):
        if s.startswith("${", i):
            depth += 1
            inner_start = i
            i += 2
            continue
        if s[i] == "}":
            if depth == 1:
                return (inner_start, i)
            # close of innermost nested span
            return (inner_start, i)
        i += 1
    return None


def _lookup(tree: dict, node_path: list[str], ref: str) -> Any:
    """Resolve a reference path, absolute or dot-relative, against the tree."""
    if ref.startswith("."):
        ups = 0
        while ups < len(ref) and ref[ups] == ".":
            ups += 1
        rel = ref[ups:]
        # one leading dot = current node; each extra dot = one level up
        base_path = node_path[: len(node_path) - (ups - 1)] if ups > 1 else list(node_path)
        parts = base_path + ([p for p in rel.split(".") if p] if rel else [])
    else:
        parts = [p for p in ref.split(".") if p]
    node: Any = tree
    for p in parts:
        if isinstance(node, dict) and p in node:
            node = node[p]
        else:
            raise KeyError(f"Interpolation key not found: {ref!r} (at {'.'.join(node_path)})")
    return node


def _coerce(v: Any) -> Any:
    if isinstance(v, str):
        return yaml.safe_load(v)
    return v


def _eval_resolver(name: str, args: list[Any]) -> Any:
    if name == "oc_env":
        var = args[0]
        default = args[1] if len(args) > 1 else None
        return os.environ.get(var, default)
    if name == "eq":
        a, b = (_coerce(x) for x in args)
        return a == b
    if name == "if":
        cond, a, b = args
        cond = _coerce(cond) if isinstance(cond, str) else cond
        return _coerce(a) if cond else _coerce(b)
    if name == "divide":
        a, b = (_coerce(x) for x in args)
        out = a / b
        return int(out) if float(out).is_integer() else out
    if name == "mult":
        a, b = (_coerce(x) for x in args)
        out = a * b
        return int(out) if float(out).is_integer() else out
    raise ValueError(f"Unknown resolver: {name!r}")


def _split_args(body: str) -> list[str]:
    """Split resolver args on top-level commas."""
    args, depth, cur = [], 0, []
    for ch in body:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        args.append("".join(cur).strip())
    return args


_RESOLVER_RE = re.compile(r"^(eq|if|divide|mult|oc_env):(.*)$", re.S)


def _eval_interp(tree: dict, node_path: list[str], body: str) -> Any:
    body = body.strip()
    m = _RESOLVER_RE.match(body)
    if m:
        name, argstr = m.group(1), m.group(2)
        args = _split_args(argstr)
        return _eval_resolver(name, args)
    return _lookup(tree, node_path, body)


class _Unresolved(Exception):
    pass


def _resolve_str(tree: dict, node_path: list[str], s: str) -> Any:
    """Resolve all interpolations in a string; returns typed value if the
    whole string is a single interpolation."""
    for _ in range(_MAX_PASSES):
        span = _find_interp(s)
        if span is None:
            return s
        a, b = span
        body = s[a + 2 : b]
        if "${" in body:
            raise _Unresolved(s)
        val = _eval_interp(tree, node_path, body)
        if isinstance(val, str) and "${" in val:
            raise _Unresolved(s)  # referenced value not resolved yet
        if a == 0 and b == len(s) - 1:
            if isinstance(val, (dict, list)):
                return copy.deepcopy(val)
            return val
        sval = "" if val is None else (str(val).lower() if isinstance(val, bool) else str(val))
        s = s[:a] + sval + s[b + 1 :]
    raise ValueError(f"Interpolation did not converge: {s!r}")


def _resolve_tree(tree: dict) -> dict:
    """Iteratively resolve interpolations to a fixpoint."""
    for _ in range(_MAX_PASSES):
        changed = [False]
        pending = [False]

        def walk(node: Any, path: list[str]) -> Any:
            if isinstance(node, dict):
                return {k: walk(v, path + [k]) for k, v in node.items()}
            if isinstance(node, list):
                # a list element's interpolation context is the list node itself
                return [walk(v, path + ["<item>"]) for v in node]
            if isinstance(node, str) and "${" in node:
                try:
                    out = _resolve_str(tree, path[:-1], node)
                    changed[0] = True
                    return out
                except (_Unresolved, KeyError):
                    pending[0] = True
                    return node
            return node

        tree = walk(tree, [])
        if not pending[0]:
            return tree
        if not changed[0]:
            # leftover unresolvable interpolations: resolve what we can't to error later
            break

    def find_bad(node: Any, path: str) -> str | None:
        if isinstance(node, dict):
            for k, v in node.items():
                r = find_bad(v, f"{path}.{k}" if path else k)
                if r:
                    return r
        elif isinstance(node, list):
            for v in node:
                r = find_bad(v, path)
                if r:
                    return r
        elif isinstance(node, str) and "${" in node:
            return f"{path} = {node!r}"
        return None

    bad = find_bad(tree, "")
    raise ValueError(f"Unresolvable interpolation: {bad}")
