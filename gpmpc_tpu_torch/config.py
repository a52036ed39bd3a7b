"""Structured experiment configuration. Port of `gpmpc_tpu/config.py`: the
same dataclasses, validation, `load_config` and `mkdir_date`, read by a YAML
reader of its own (`read_yaml`), so the port needs no PyYAML.

`read_yaml` reads the subset of YAML that the schema uses and raises
`YamlSubsetError`, naming the line, on anything else:

- block mappings (a key, a colon, then a value or a more indented block),
  keys being bare identifiers;
- flow lists of numbers on one line (`[8, 0.1, -3]`, `[]`);
- ints, floats (`0.001`, `1e-3`, `-72.08`), `true`/`false`, `null` (`~`
  and an empty value too), single- or double-quoted strings without
  backslash escapes, and bare strings;
- `#` comments, on their own line or after a value.

Inside that subset it gives what `yaml.safe_load` gives, with one exception:
a float with an exponent but no decimal point or no exponent sign (`1e-3`,
`1.0e3`) is a float here, as in YAML 1.2, where PyYAML's YAML 1.1 resolver
reads a string. Bare words that YAML 1.1 reads as booleans (`yes`, `no`,
`on`, `off`) and numbers in other notations (`0x1f`, `1_000`, `010`) raise
instead of guessing.

The `device` field, informational in the reference, chooses where the port
runs: `"tpu"` (the shipped YAML's value) and `null` mean the default device,
the CUDA card (`device.py::resolve`); `"cuda"`, `"cuda:N"` and `"cpu"` pass
through; anything else raises.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, fields
from datetime import datetime
from itertools import chain, count
from pathlib import Path
from typing import Any


class YamlSubsetError(ValueError):
    """The document uses YAML outside the subset `read_yaml` reads."""


_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?(([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?|[0-9]+[eE][-+]?[0-9]+)")
_NUMBERISH = re.compile(r"[-+.]?[0-9]")
_NULL = ("null", "Null", "NULL", "~", "")
_TRUE, _FALSE = ("true", "True", "TRUE"), ("false", "False", "FALSE")
# YAML 1.1 reads these bare words as booleans; the subset asks for quotes
_AMBIGUOUS = {"yes", "no", "on", "off"}
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


def _strip_comment(text: str, lineno: int) -> str:
    """`text` without a trailing `# comment` (a `#` at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    if quote:
        raise YamlSubsetError(f"line {lineno}: unterminated quoted string")
    return text.rstrip()


def _number(token: str, lineno: int):
    if _INT.fullmatch(token):
        return int(token)
    if _FLOAT.fullmatch(token):
        return float(token)
    raise YamlSubsetError(f"line {lineno}: {token!r} is not a number of the subset "
                          "(decimal ints and floats only)")


def _scalar(token: str, lineno: int):
    if token in _NULL:
        return None
    if token in _TRUE:
        return True
    if token in _FALSE:
        return False
    if token[0] == "[":
        if not token.endswith("]"):
            raise YamlSubsetError(f"line {lineno}: a flow list must close on its own line")
        body = token[1:-1].strip()
        return [] if not body else [_number(t.strip(), lineno) for t in body.split(",")]
    if token[0] == '"':
        if len(token) < 2 or token[-1] != '"' or '"' in token[1:-1] or "\\" in token:
            raise YamlSubsetError(f"line {lineno}: double-quoted string outside the subset "
                                  "(one string, no backslash escapes)")
        return token[1:-1]
    if token[0] == "'":
        inner = token[1:-1]
        if len(token) < 2 or token[-1] != "'" or "'" in inner.replace("''", ""):
            raise YamlSubsetError(f"line {lineno}: single-quoted string outside the subset")
        return inner.replace("''", "'")
    if _NUMBERISH.match(token):
        return _number(token, lineno)
    if token.lstrip("+-").lower() in (".inf", ".nan"):
        raise YamlSubsetError(f"line {lineno}: {token!r} is outside the subset")
    if token.lower() in _AMBIGUOUS:
        raise YamlSubsetError(f"line {lineno}: {token!r} is a boolean in YAML 1.1; quote it or "
                              "write true/false")
    if token[0] in _INDICATORS or ": " in token or token.endswith(":"):
        raise YamlSubsetError(f"line {lineno}: {token!r} is outside the subset (block "
                              "mappings, flow lists of numbers, scalars)")
    return token


def read_yaml(text: str):
    """The document `text` as Python values: a dict of the top-level
    mapping (None for an empty document). Raises `YamlSubsetError` naming
    the line of the first construct outside the subset."""
    lines = []  # (line number, indent, content)
    for lineno, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"line {lineno}: tab in the indentation")
        content = _strip_comment(raw.strip(), lineno)
        if not content:
            continue
        if content in ("---", "...") or content.startswith("%"):
            raise YamlSubsetError(f"line {lineno}: document markers and directives are outside "
                                  "the subset")
        lines.append((lineno, len(raw) - len(raw.lstrip(" ")), content))
    if not lines:
        return None
    pos = 0

    def mapping(indent: int) -> dict:
        nonlocal pos
        out = {}
        while pos < len(lines):
            lineno, ind, content = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"line {lineno}: unexpected indentation")
            key, sep, rest = content.partition(":")
            if not sep or not _KEY.fullmatch(key) or (rest and rest[0] != " "):
                raise YamlSubsetError(f"line {lineno}: expected `key: value` with a bare "
                                      f"identifier key, got {content!r}")
            if key in out:
                raise YamlSubsetError(f"line {lineno}: duplicate key {key!r}")
            rest = rest.strip()
            pos += 1
            if not rest and pos < len(lines) and lines[pos][1] > indent:
                out[key] = mapping(lines[pos][1])
            else:
                out[key] = _scalar(rest, lineno)
        return out

    doc = mapping(lines[0][1])
    if pos < len(lines):
        raise YamlSubsetError(f"line {lines[pos][0]}: inconsistent indentation")
    return doc


def _build(cls, data: dict[str, Any]):
    names = {f.name for f in fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"Unknown config keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**data)


def map_device(device: str | None) -> str | None:
    """The config's `device` as the port reads it: None (the card) for
    "tpu" or null; "cpu", "cuda" and "cuda:N" as given."""
    if device is None or device == "tpu":
        return None
    if device in ("cpu", "cuda") or re.fullmatch(r"cuda:[0-9]+", str(device)):
        return device
    raise ValueError(f"gpmpc.device must be 'tpu' (the default device), 'cuda', 'cuda:N' or "
                     f"'cpu', got {device!r}")


@dataclass
class GpMpcSection:
    horizon: int = 25
    q_mpc: list = field(
        default_factory=lambda: [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
    )
    r_mpc: list = field(default_factory=lambda: [3, 3, 3, 0.1])
    prior_params: dict = field(
        default_factory=lambda: {
            "a": 12.1432, "b": 1.8118, "c": -72.08, "d": -7.5755,
            "e": 39.8653, "f": -72.08, "h": -7.5755, "l": 39.8653,
        }
    )
    prob: float = 0.95
    device: str | None = "tpu"  # mapped by `map_device`: None is the card
    sparse_gp: bool = True
    max_gp_samples: int = 40
    # the solver's settings, beyond the schema of the reference's own reference:
    sqp_iters: int = 25
    qp_iters: int = 15  # interior-point iterations per QP
    max_gp_points: int = 128  # padded GP dataset capacity
    parallel_scan: bool = False  # O(log T) associative-scan Riccati on the xla path
    # L1 penalty weight of soft chance-tightened state bounds; None keeps them hard
    soft_constraints: float | None = None
    lm_reg: float = 0.0  # Levenberg-Marquardt damping of the SQP's Hessian blocks
    # "auto": lanes on the card where the lanes caps serve the horizon, else xla
    step_backend: str = "auto"

    _STEP_BACKENDS = ("auto", "lanes", "xla")

    def __post_init__(self):
        if self.prior_params is None or any(
            k not in self.prior_params for k in ("a", "b")
        ):
            raise ValueError("gpmpc requires prior_params containing 'a' and 'b'.")
        assert len(self.q_mpc) == 12 and len(self.r_mpc) == 4
        if self.step_backend not in self._STEP_BACKENDS:
            raise ValueError(
                f"step_backend must be one of {self._STEP_BACKENDS}, "
                f"got {self.step_backend!r}"
            )
        self.device = map_device(self.device)


@dataclass
class RunSection:
    num_epochs: int = 3


@dataclass
class TrainSection:
    eval_size: float = 0.2
    iterations: int = 500
    lr: float = 0.001
    samples_per_epoch: int = 15


@dataclass
class Config:
    save_dir: str = "saves/"
    task: str = "quadrotor"
    seed: int = 1
    gpmpc: GpMpcSection = field(default_factory=GpMpcSection)
    run: RunSection = field(default_factory=RunSection)
    train: TrainSection = field(default_factory=TrainSection)

    @classmethod
    def from_yaml(cls, path: str | Path) -> "Config":
        return cls.from_dict(read_yaml(Path(path).read_text()))

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Config":
        raw = dict(raw or {})
        sections = {
            "gpmpc": _build(GpMpcSection, raw.pop("gpmpc", {})),
            "run": _build(RunSection, raw.pop("run", {})),
            "train": _build(TrainSection, raw.pop("train", {})),
        }
        return _build(Config, {**raw, **sections})


def load_config(path: str | Path, make_save_dir: bool = True) -> Config:
    """Load a config and, with `make_save_dir`, claim a timestamped save dir
    under its `save_dir` (`claim_save_dir`)."""
    cfg = Config.from_yaml(path)
    if make_save_dir:
        claim_save_dir(cfg)
    return cfg


def claim_save_dir(cfg: Config) -> Path:
    """Create a fresh timestamped directory under `cfg.save_dir` (a relative
    root is anchored at the current directory), store it in `cfg.save_dir`
    and return it."""
    root = Path(cfg.save_dir)
    if not root.is_absolute():
        root = Path.cwd() / root
    root.mkdir(parents=True, exist_ok=True)
    out = mkdir_date(root)
    cfg.save_dir = str(out)
    return out


def mkdir_date(path: Path) -> Path:
    """Create and return a fresh timestamped results directory under `path`:
    a minute-resolution timestamp, `_(k)` appended on a collision, claimed
    with an exclusive mkdir so that two runs started in the same minute never
    share one directory."""
    if not path.is_dir():
        raise NotADirectoryError(f"save root {path} is not a directory")
    stamp = datetime.now().strftime("%Y_%m_%d_%H_%M")
    for suffix in chain([""], (f"_({k})" for k in count(1))):
        candidate = path / f"{stamp}{suffix}"
        try:
            candidate.mkdir()
        except FileExistsError:
            continue
        return candidate
