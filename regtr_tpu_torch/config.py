"""Config loader for the shipped `conf/*.yaml` files, without PyYAML.

`regtr_tpu.config` imports `yaml` at module level, and the machines the port
runs on carry no PyYAML.  This module reads the subset of YAML the shipped
files use -- top-level sections of `key: value` pairs, plain and quoted
scalars, flow lists (which may span lines), and `#` comments -- resolves
scalars the way PyYAML's `safe_load` does, and flattens the sections into
one plain dict over `TPU_DEFAULTS`, as `regtr_tpu.config.load_config`
does.  Anything outside that subset raises instead of being misread.
`dump_yaml_sections` writes the same subset back, so that PyYAML and this
loader read the file to the dict it was given.
"""
from __future__ import annotations

import copy
import re
from pathlib import Path

CONF_DIR = Path(__file__).resolve().parent.parent / "conf"

# Same values as regtr_tpu.config.TPU_DEFAULTS (a CPU test holds them equal).
TPU_DEFAULTS = {
    "buckets": [4096, 8192, 16384, 32768],
    "capacity_factor": 0.5,
    "level_capacities": None,
    "neighbor_chunk": 1024,
    "neighbor_recall": 0.95,
    "sort_input": True,
    "attention_impl": "auto",
    "compute_dtype": "float32",
    "kernel_seed": 0,
    "mesh_axis": "data",
}


# PyYAML's YAML 1.1 implicit resolvers for the scalar kinds it recognises.
_BOOL = {w: value for value, words in ((True, "yes true on"),
                                       (False, "no false off"))
         for base in words.split()
         for w in (base, base.capitalize(), base.upper())}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$"
    r"|^[-+]?\.(inf|Inf|INF)$|^\.(nan|NaN|NAN)$")


def _scalar(tok: str, where: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        body = tok[1:-1]
        return body.replace("''", "'") if tok[0] == "'" else body
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        low = tok.lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith("nan"):
            return float("nan")
        return float(tok.replace("_", ""))
    if tok[0] in "[]{}&*!|>%@`-?" or ": " in tok:
        raise ValueError(f"{where}: unsupported YAML value {tok!r}")
    return tok


def _split_flow(body: str, where: str) -> list:
    """Split the inside of a flow list on commas outside quotes."""
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur)
            cur = ""
        elif ch in "[]{}":
            raise ValueError(f"{where}: nested flow collections unsupported")
        else:
            cur += ch
    if cur.strip():
        items.append(cur)
    return [_scalar(t, where) for t in items]


def _strip_comment(line: str) -> str:
    """Drop a `#` comment (at the start or after whitespace, not quoted)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml_sections(text: str, name: str = "<yaml>") -> dict:
    """Parse the two-level section/key YAML subset into nested dicts."""
    out: dict = {}
    section = None
    pending = None          # (key, accumulated flow-list text)
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{lineno}"
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            key, acc = pending
            acc += " " + line.strip()
            if acc.endswith("]"):
                section_dict[key] = _split_flow(acc[1:-1], where)
                pending = None
            else:
                pending = (key, acc)
            continue
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        if "\t" in line[:indent + 1]:
            raise ValueError(f"{where}: tabs are not valid YAML indentation")
        body = line.strip()
        key, sep, value = body.partition(":")
        if not sep or (value and not value.startswith(" ")):
            raise ValueError(f"{where}: expected 'key: value', got {body!r}")
        key, value = key.strip(), value.strip()
        if indent == 0:
            if value:
                raise ValueError(f"{where}: top-level key {key} must be a "
                                 f"section")
            section = key
            section_dict = out.setdefault(section, {})
            continue
        if section is None:
            raise ValueError(f"{where}: indented key outside a section")
        if value.startswith("["):
            if value.endswith("]"):
                section_dict[key] = _split_flow(value[1:-1], where)
            else:
                pending = (key, value)
        else:
            section_dict[key] = _scalar(value, where)
    if pending is not None:
        raise ValueError(f"{name}: unterminated flow list for {pending[0]}")
    return out


def _emit_scalar(v, where: str) -> str:
    """v as a YAML scalar that PyYAML's safe_load and `_scalar` both read
    back to v."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return repr(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return "-.inf" if v < 0 else ".inf"
        text = repr(v)
        # YAML 1.1 reads a float only with a dot: 1e-05 -> 1.0e-05
        if "." not in text:
            text = text.replace("e", ".0e")
        return text
    if isinstance(v, str) and "\n" not in v:
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(f"{where}: cannot write {v!r} in the two-level YAML "
                     "subset")


def dump_yaml_sections(raw: dict) -> str:
    """Write {section: {key: value}} (scalars and flat lists of scalars) as
    YAML text in the subset `parse_yaml_sections` reads."""
    lines = []
    for section, entries in raw.items():
        if not isinstance(entries, dict) or not entries:
            raise ValueError(f"section {section!r}: the two-level YAML "
                             "subset needs a non-empty mapping")
        lines.append(f"{section}:")
        for key, v in entries.items():
            where = f"{section}.{key}"
            text = ("[" + ", ".join(_emit_scalar(x, where) for x in v) + "]"
                    if isinstance(v, (list, tuple)) else _emit_scalar(v, where))
            lines.append(f"  {key}: {text}")
    return "\n".join(lines) + "\n"


def load_config(path) -> dict:
    """Load a two-level YAML config into one flat dict over TPU_DEFAULTS."""
    raw = parse_yaml_sections(Path(path).read_text(), str(path))
    cfg = copy.deepcopy(TPU_DEFAULTS)
    for entries in raw.values():
        cfg.update(entries)
    cfg["config_path"] = str(Path(path).resolve())
    return cfg


def _load(name: str, **overrides) -> dict:
    cfg = load_config(CONF_DIR / f"{name}.yaml")
    cfg.update(overrides)
    return cfg


def threedmatch_config(**overrides) -> dict:
    return _load("3dmatch", **overrides)


def modelnet_config(**overrides) -> dict:
    return _load("modelnet", **overrides)


def tiny_config(**overrides) -> dict:
    """Small fast config for tests (same overrides as regtr_tpu.presets)."""
    cfg = modelnet_config(
        first_feats_dim=64,
        d_embed=64,
        nhead=4,
        d_feedforward=128,
        num_encoder_layers=2,
        neighborhood_limits=[12, 12],
        overlap_loss_on=[1], feature_loss_on=[1], corr_loss_on=[1],
        capacity_factor=0.8,
        neighbor_chunk=256,
    )
    cfg.update(overrides)
    return cfg
