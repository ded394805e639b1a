"""PDAL-style pipeline reader: survey ascii/csv -> clean x,y,z table.

Counterpart of ``deepbedmap_tpu/data/pipeline.py``, without pandas (the
card's machine has none). Reference ``ascii_to_xyz`` (data_prep.py:259-336)
interprets per-survey JSON configs (highres/*.json) with a ``readers.text``
stage (skip/separator/header/usecols/na_values + optional ``converters``
column math and ``dropcols``) and an optional ``filters.reprojection`` stage
(EPSG:4326 -> EPSG:3031). This module reads the same JSON format and gives
what the JAX package's ``pd.read_csv`` calls give, value for value:

- ``skip`` non-blank rows before the header row, whose names ``header``
  replaces; blank lines are not rows;
- ``,`` and tab separators with ``"`` quoting (the ``csv`` module), or the
  regex ``\\s+`` (runs of spaces and tabs, leading ones ignored);
- ``usecols`` by name; a short row reads NaN in its missing fields and the
  fields past the header's are ignored;
- pandas' default NA strings plus ``na_values``;
- single-member ``.zip`` files, and multi-file globs concatenated in sorted
  order;
- numbers parsed as pandas' C parser parses them (``parse_floats``: its
  ``precise_xstrtod``, which is not correctly rounded for 16 or more
  significant digits);
- the converter form ``A-B``; any other expression raises ``ValueError``.

Reprojection uses the port's own polar-stereographic transform
(``data.proj``) instead of pyproj.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import io
import json
import os
import re
import zipfile
from typing import Dict, List, Sequence

import numpy as np

from deepbedmap_tpu_torch.data.proj import lonlat_to_xy

# The 11 reference surveys ship as packaged pipeline configs
# (deepbedmap_tpu_torch/data/surveys/*.json, copies of the JAX package's,
# mirroring the reference highres/*.json that data_prep.py:340-345 iterates)
SURVEYS_DIR = os.path.join(os.path.dirname(__file__), "surveys")

# pandas.read_csv's default NA strings (``keep_default_na``): a field equal
# to one of them, after the quotes are taken off, reads as NaN
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
# what pandas' parser reads as an infinity, in any case
_INFINITIES = {"inf": np.inf, "+inf": np.inf, "-inf": -np.inf,
               "infinity": np.inf, "+infinity": np.inf, "-infinity": -np.inf}
# the C parser's table of powers of ten: correctly rounded literals
_POW10 = np.array([float(f"1e{k}") for k in range(309)])
_MAX_DIGITS = 17


@dataclasses.dataclass(frozen=True)
class XYZ:
    """A survey's points: float64 numpy columns ``x``, ``y``, ``z``. Every
    function of the data-prep path also takes any object with ``.x``, ``.y``
    and ``.z`` columns (a pandas DataFrame, for one)."""

    x: np.ndarray
    y: np.ndarray
    z: np.ndarray

    def __len__(self) -> int:
        return len(self.x)


def list_survey_configs() -> list[str]:
    """Paths of the packaged per-survey pipeline configs, sorted by name."""
    return sorted(glob.glob(os.path.join(SURVEYS_DIR, "*.json")))


def survey_config_path(name: str) -> str:
    """Path of one packaged survey config, e.g. ``'2010tr'``."""
    path = os.path.join(SURVEYS_DIR, name + ".json")
    if not os.path.exists(path):
        raise ValueError(f"unknown survey {name!r}; see list_survey_configs()")
    return path


def _xstrtod(words: List[str]) -> np.ndarray:
    """pandas' ``precise_xstrtod`` (its C parser's default float conversion)
    over a list of words, vectorised over the words: leading and trailing
    ASCII whitespace, an optional sign, at most 17 significant digits
    accumulated in float64 (``number * 10 + digit``, each step rounded; the
    rest of the integer digits raise the exponent, the rest of the decimals
    are dropped), an optional exponent, then one multiplication or division
    by a correctly rounded power of ten. A word it does not read whole
    raises ``ValueError``, unless it is an infinity word."""
    try:
        raw = np.array(words, dtype=bytes)
    except UnicodeEncodeError as e:
        raise ValueError(f"not a number: {e.object!r}") from None
    n = len(words)
    u = np.zeros((n, raw.dtype.itemsize + 1), np.uint8)
    u[:, :-1] = raw.view(np.uint8).reshape(n, -1)
    width = u.shape[1] - 1
    length = np.char.str_len(raw)
    rows = np.arange(n)
    cols = np.arange(width + 1)

    def after(mask):
        # per (row, column): the first column at or after it outside ``mask``
        m = np.where(mask, width, cols)
        return np.minimum.accumulate(m[:, ::-1], axis=1)[:, ::-1]

    after_space = after((u == 32) | ((u >= 9) & (u <= 13)))
    after_digit = after((u >= 48) & (u <= 57))

    p = after_space[:, 0]
    negative = u[rows, p] == ord("-")
    p = p + (negative | (u[rows, p] == ord("+")))
    int_start = p
    n_int = after_digit[rows, p] - p
    p = p + n_int
    dot = u[rows, p] == ord(".")
    p = p + dot
    frac_start = p
    n_frac = np.where(dot, after_digit[rows, p] - p, 0)
    p = p + n_frac
    int_used = np.minimum(n_int, _MAX_DIGITS)
    n_digits = int_used + np.minimum(n_frac, _MAX_DIGITS - int_used)
    bad = n_digits == 0

    number = np.zeros(n)
    for k in range(_MAX_DIGITS):
        at = np.minimum(np.where(k < n_int, int_start + k, frac_start + k - n_int), width)
        digit = u[rows, at].astype(np.float64) - 48.0
        number = np.where(k < n_digits, number * 10.0 + digit, number)
    exponent = np.maximum(n_int - _MAX_DIGITS, 0) - (n_digits - int_used)
    number = np.where(negative, -number, number)

    sci = (u[rows, p] == ord("e")) | (u[rows, p] == ord("E"))
    p = p + sci
    exp_negative = sci & (u[rows, p] == ord("-"))
    p = p + (sci & (exp_negative | (u[rows, p] == ord("+"))))
    n_exp = np.where(sci, after_digit[rows, p] - p, 0)
    bad |= sci & ((n_exp == 0) | (n_exp > _MAX_DIGITS))
    value = np.zeros(n, np.int64)
    for k in range(min(int(n_exp.max(initial=0)), _MAX_DIGITS)):
        digit = u[rows, np.minimum(p + k, width)].astype(np.int64) - 48
        value = np.where(k < n_exp, value * 10 + digit, value)
    p = p + n_exp
    exponent = exponent + np.where(exp_negative, -value, value)
    bad |= after_space[rows, np.minimum(p, width)] != length

    e = np.clip(exponent, -616, 309)
    with np.errstate(over="ignore"):
        scaled = np.where(
            e > 0, number * _POW10[np.clip(e, 0, 308)],
            np.where(e >= -308, number / _POW10[np.clip(-e, 0, 308)],
                     number / _POW10[np.clip(-308 - e, 0, 308)] / _POW10[308]))
    # beyond the table pandas reads ±inf (or +0 for a zero mantissa); far
    # below it the C code sets +0
    scaled = np.where(exponent > 308, np.where(number == 0, 0.0,
                                               np.copysign(np.inf, number)), scaled)
    scaled = np.where(exponent < -616, 0.0, scaled)
    for i in np.nonzero(bad)[0]:
        inf = _INFINITIES.get(words[i].lower())
        if inf is None:
            raise ValueError(f"not a number: {words[i]!r}")
        scaled[i] = inf
    return scaled


def parse_floats(fields: Sequence[str], na_values=NA_STRINGS) -> np.ndarray:
    """Float64 values of text fields as ``pandas.read_csv`` reads a float
    column: a field in ``na_values`` is NaN, ``inf`` or ``infinity`` with an
    optional sign, in any case, is ±inf, and the rest go through pandas'
    ``precise_xstrtod`` (``_xstrtod``). A field that is not a number raises
    ``ValueError``."""
    keep = np.fromiter((f not in na_values for f in fields), bool, len(fields))
    out = np.full(len(fields), np.nan)
    if keep.any():
        out[keep] = _xstrtod([f for f in fields if f not in na_values])
    return out


def _read_text(path: str) -> str:
    """A file's text; a ``.zip`` must hold one member, as pandas infers and
    requires. A UTF-8 byte-order mark is dropped, as pandas' parser drops it."""
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as zf:
            members = zf.namelist()
            if len(members) != 1:
                raise ValueError(f"{path}: a zip must hold one file, found {members}")
            data = zf.read(members[0])
    else:
        with open(path, "rb") as f:
            data = f.read()
    return data.decode("utf-8-sig")


def _rows(text: str, sep: str) -> List[List[str]]:
    """The non-blank rows of ``text`` split into fields: pandas' C tokenizer
    for a one-character separator (quotes, a line of only spaces or tabs
    other than the separator is blank), or its whitespace tokenizer for the
    regex ``\\s+``."""
    if sep == "\\s+":
        rows = []
        for line in re.split(r"\r\n|\r|\n", text):
            line = line.strip(" \t")
            if not line:
                continue
            if '"' in line:
                raise ValueError("quoted fields with the separator \\s+ are not read")
            rows.append(re.split(r"[ \t]+", line))
        return rows
    if len(sep) != 1:
        raise ValueError(f"separator {sep!r}: one character or \\s+")
    blank = " \t".replace(sep, "")
    return [row for row in csv.reader(io.StringIO(text, newline=""), delimiter=sep)
            if row and not (len(row) == 1 and not row[0].strip(blank))]


def read_survey_table(path: str, sep: str, skip: int, names: Sequence[str],
                      usecols: Sequence[str], na_values=None) -> Dict[str, np.ndarray]:
    """``pd.read_csv(path, sep=sep, header=skip, names=names, usecols=usecols,
    na_values=na_values)`` as float64 columns keyed by name, in ``names``'
    order."""
    missing = [c for c in usecols if c not in names]
    if missing:
        raise ValueError(f"{path}: usecols {missing} not in the header {list(names)}")
    na = NA_STRINGS if na_values is None else NA_STRINGS | set(
        [na_values] if isinstance(na_values, str) else na_values)
    body = _rows(_read_text(path), sep)[skip + 1:]
    table = {}
    for name in names:
        if name not in usecols:
            continue
        i = names.index(name)
        try:
            table[name] = parse_floats([r[i] if i < len(r) else "" for r in body], na)
        except ValueError as e:
            raise ValueError(f"{path}: column {name!r}: {e}") from None
    return table


def _difference(expr: str, columns: Dict[str, np.ndarray]) -> np.ndarray:
    """The converter column ``A-B``, the one form the reference configs use;
    any other expression raises instead of being evaluated."""
    m = re.fullmatch(r"\s*([A-Za-z_]\w*)\s*-\s*([A-Za-z_]\w*)\s*", expr)
    if m is None or m.group(1) not in columns or m.group(2) not in columns:
        raise ValueError(
            f"converter {expr!r}: only 'A-B' over two read columns is supported")
    return columns[m.group(1)] - columns[m.group(2)]


def ascii_to_xyz(pipeline_file: str, data_dir: str | None = None) -> XYZ:
    """Run a pipeline JSON; returns the points as an ``XYZ`` table.

    ``data_dir`` overrides where the reader's ``filename`` glob is anchored
    (defaults to the config's own directory, matching the reference layout
    where configs sit next to the survey files).
    """
    if not (pipeline_file.endswith(".json") and os.path.exists(pipeline_file)):
        raise ValueError(f"no pipeline JSON at {pipeline_file}")

    with open(pipeline_file) as f:
        doc = json.load(f)
    stages: Dict[str, Dict] = {s["type"]: s for s in doc["pipeline"]}
    reader = stages["readers.text"]

    sep = reader["separator"]
    skip = int(reader["skip"])
    names = reader["header"].split(sep)
    usecols = reader["usecols"].split(sep)

    base = data_dir if data_dir is not None else os.path.dirname(pipeline_file)
    pattern = os.path.join(base, reader["filename"])
    files = sorted(glob.glob(pattern))
    if not files:
        raise ValueError(f"no files match {pattern}")

    tables = [read_survey_table(f, sep, skip, names, usecols, reader.get("na_values"))
              for f in files]
    columns = {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}
    keep = ~np.any([np.isnan(v) for v in columns.values()], axis=0)
    columns = {k: v[keep] for k, v in columns.items()}

    # optional column math + drops (e.g. WGS84 ellipsoid datum shifts)
    if "converters" in reader:
        converters = dict(reader["converters"])
        newcol, expr = converters.popitem()
        columns[newcol] = _difference(expr, columns)
        for col in reader["dropcols"].split(sep):
            del columns[col]

    if len(columns) != 3:
        raise ValueError(f"{pipeline_file}: expected three columns, got {list(columns)}")
    x, y, z = (columns[k] for k in sorted(columns))

    # optional reprojection (the reference configs use EPSG:4326 -> 3031)
    if "filters.reprojection" in stages:
        reproj = stages["filters.reprojection"]
        if not ("4326" in str(reproj.get("in_srs", "4326"))
                and "3031" in str(reproj.get("out_srs", "3031"))):
            raise ValueError(f"reprojection {reproj}: only EPSG:4326 -> EPSG:3031")
        x, y = lonlat_to_xy(x, y)

    return XYZ(np.asarray(x, np.float64), np.asarray(y, np.float64),
               np.asarray(z, np.float64))
