"""Config/CLI system: argparse + ``.cfg`` config files.

Port of ``strive_tpu/utils/config.py`` (reference ``utils/config.py:8-79``):
same flag names and defaults, same precedence (CLI > config file >
defaults). ``-c file.cfg`` loads a mapping whose keys override parser
defaults.

The config files are a small subset of YAML, and the port reads them
without PyYAML: one ``key: value`` a line, ``#`` comments, quoted strings,
``true``/``false``, ints, floats and one-line ``[a, b]`` lists. A scalar
resolves as PyYAML's ``safe_load`` resolves it (so ``1e-4``, which has no
dot, stays the string ``'1e-4'`` there and here; argparse then converts it
with the flag's type). Anything outside the subset raises ``ValueError``,
so a file this reader cannot read fails loudly and is never misread.
"""

from __future__ import annotations

import argparse
import re
import sys

_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$")
# PyYAML's resolvers (YAML 1.1) for the forms the subset takes
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
# plain scalars PyYAML would resolve to something the subset has no
# counterpart for: null, YAML 1.1 booleans, octal/hex/binary/underscored or
# sexagesimal ints, .inf/.nan, timestamps
_OTHER_YAML = re.compile(
    r"^(?:~|null|Null|NULL|yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF|y|Y|n|N"
    r"|[-+]?0[0-9_]+|[-+]?0[xXbBoO].*|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+.*"
    r"|[-+]?[0-9][0-9_.]*_[0-9_.]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|[0-9]{4}-[0-9][0-9]?-[0-9][0-9]?.*|<<|=)$")
_PLAIN_STR = re.compile(r"^[A-Za-z0-9_./+][A-Za-z0-9_./+\-]*$|^-[A-Za-z0-9_./+\-]+$")


def _strip_comment(line):
    """Drop a ``#`` comment (at the line's start or after whitespace,
    outside quotes)."""
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


def _scalar(tok, where):
    """One scalar token -> its value, as PyYAML resolves it."""
    tok = tok.strip()
    if not tok:
        raise ValueError(f"{where}: empty value")
    if tok[0] == "'":
        if len(tok) < 2 or tok[-1] != "'" or "'" in tok[1:-1].replace("''", ""):
            raise ValueError(f"{where}: malformed single-quoted string {tok!r}")
        return tok[1:-1].replace("''", "'")
    if tok[0] == '"':
        body = tok[1:-1]
        if len(tok) < 2 or tok[-1] != '"' or '"' in body or "\\" in body:
            raise ValueError(f"{where}: unsupported double-quoted string {tok!r}")
        return body
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if _OTHER_YAML.match(tok) or not _PLAIN_STR.match(tok):
        raise ValueError(f"{where}: value {tok!r} is outside the config subset")
    return tok


def _split_list(body, where):
    """Split a flow list's body on commas outside quotes."""
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch in "[]{}":
            raise ValueError(f"{where}: nested collections are not supported")
        elif ch == ",":
            items.append(cur)
            cur = ""
        else:
            cur += ch
    if quote:
        raise ValueError(f"{where}: unterminated string in list")
    items.append(cur)
    if len(items) == 1 and not items[0].strip():
        return []
    return items


def _value(text, where):
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: a list must close on its line")
        return [_scalar(t, where) for t in _split_list(text[1:-1], where)]
    return _scalar(text, where)


def read_config(path):
    """Read a ``.cfg`` file (module doc) -> dict, as ``yaml.safe_load``
    would give it (``{}`` for an empty file). Raises ``ValueError`` on a
    line outside the subset."""
    out = {}
    with open(path) as f:
        lines = f.read().splitlines()
    for no, raw in enumerate(lines, 1):
        where = f"{path}:{no}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: indented lines are not supported")
        m = _KEY.match(line)
        if m is None or m.group(2) is None:
            raise ValueError(f"{where}: expected 'key: value', got {raw!r}")
        key = m.group(1)
        if key in out:
            raise ValueError(f"{where}: key {key!r} given twice")
        out[key] = _value(m.group(2), where)
    return out


class ConfigParser(argparse.ArgumentParser):
    """ArgumentParser with an optional ``-c/--config`` file."""

    def __init__(self, description=""):
        super().__init__(description=description,
                         formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        self.add_argument("-c", "--config", type=str, default=None,
                          help="config file path")

    def parse(self, argv=None):
        argv = sys.argv[1:] if argv is None else argv
        # first pass just to find the config file
        pre, _ = super().parse_known_args(argv)
        if pre.config is not None:
            cfg = read_config(pre.config)
            known = {a.dest for a in self._actions}
            unknown = [k for k in cfg if k not in known]
            if unknown:
                raise SystemExit(f"Unknown config keys in {pre.config}: {unknown}")
            for a in self._actions:
                if a.dest in cfg:
                    v = cfg[a.dest]
                    if isinstance(v, str) and a.nargs in ("+", "*"):
                        v = v.split()
                    a.default = v
                    a.required = False
        return super().parse_args(argv)


def get_parser(description):
    return ConfigParser(description)


def add_base_args(parser):
    """Shared flags (reference ``utils/config.py:20-79``)."""
    parser.add_argument("--wandb_project", type=str, default=None)
    parser.add_argument("--wandb_name", type=str, default=None)
    parser.add_argument("--wandb_offline", action="store_true", default=False)

    parser.add_argument("--out", type=str, default="./out/traffic_out",
                        help="Directory to save model weights and logs to.")

    parser.add_argument("--data_dir", type=str, default="./data/nuscenes")
    parser.add_argument("--data_version", type=str, default="trainval",
                        choices=["trainval", "mini", "synthetic"])
    parser.add_argument("--use_challenge_splits", action="store_true",
                        default=False)

    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_workers", type=int, default=2,
                        help="(unused; kept for config compatibility)")

    parser.add_argument("--past_len", type=int, default=4)
    parser.add_argument("--future_len", type=int, default=12)
    parser.add_argument("--agent_types", type=str, nargs="+",
                        default=["car", "truck"])
    parser.add_argument("--reduce_cats", action="store_true", default=False)

    parser.add_argument("--map_obs_size_pix", type=int, default=256)
    parser.add_argument("--map_obs_bounds", type=float, nargs=4,
                        default=[-17.0, -38.5, 60.0, 38.5])
    parser.add_argument("--map_layers", type=str, nargs="+",
                        default=["drivable_area", "carpark_area",
                                 "road_divider", "lane_divider"])

    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--map_feat_size", type=int, default=64)
    parser.add_argument("--past_feat_size", type=int, default=64)
    parser.add_argument("--future_feat_size", type=int, default=64)
    parser.add_argument("--latent_size", type=int, default=32)
    parser.add_argument("--no_output_bicycle", dest="model_output_bicycle",
                        action="store_false", default=True)

    parser.add_argument("--conv_kernel_list", type=int, nargs="+",
                        default=[7, 5, 5, 3, 3, 3])
    parser.add_argument("--conv_stride_list", type=int, nargs="+",
                        default=[2, 2, 2, 2, 2, 2])
    parser.add_argument("--conv_filter_list", type=int, nargs="+",
                        default=[16, 32, 64, 64, 128, 128])

    parser.add_argument("--max_agents", type=int, default=16,
                        help="Padded agents per scene (NA bucketing cap).")
    parser.add_argument("--na_buckets", type=str, default=None,
                        help="comma-separated NA bucket sizes (e.g. 8,16,32):"
                             " scenes keep ALL agents up to the largest "
                             "bucket and batches group same-bucket scenes "
                             "(default: trim to max_agents)")
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="Run model matmuls in bfloat16.")
    return parser
