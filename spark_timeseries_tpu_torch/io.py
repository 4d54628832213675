"""Persistence and parsers: CSV and Parquet panels with index sidecars,
Yahoo-finance CSV (counterpart of ``spark_timeseries_tpu/io.py``; the
same file contracts, so files interchange with the JAX package byte for
byte).

- **CSV**: a directory holding ``data.csv``, one ``key,v0,v1,...`` line
  per series, and a ``timeIndex`` sidecar with the index's string form.
- **Parquet**: a long observations table (timestamp, key, value) at
  ``<path>``, the index string in a ``<path>.idx`` sidecar.

The CSV numbers go through the native codec (``csrc/fastcsv.cpp``, the
port's copy of ``spark_timeseries_tpu/native``, built by g++ at first
use, see :func:`fastcsv`) when it builds, else through a Python path (``np.savetxt`` ``%.17g`` to write, numpy's string to
float64 cast to read, both exact), which needs no pandas.  The counters
``io.csv_codec_native`` / ``io.csv_codec_python`` count the calls that
took each.  Parquet and the Yahoo parsers import pandas inside them.
"""

from __future__ import annotations

import ctypes
import io as _io
import os
from typing import Optional

import numpy as np

from . import _build
from .panel import Panel
from .time import index as dtindex
from .utils import metrics as _metrics

CSV_DATA_FILE = "data.csv"
CSV_INDEX_FILE = "timeIndex"


# ---------------------------------------------------------------------------
# CSV
# ---------------------------------------------------------------------------

def fastcsv() -> Optional[ctypes.CDLL]:
    """The CSV codec's library with its C signatures, built on first
    use; None when g++ cannot build it."""
    lib = _build.host_library("fastcsv")
    if lib is not None and lib.sts_format_csv.restype is not ctypes.c_longlong:
        LL = ctypes.c_longlong
        lib.sts_format_csv.restype = LL
        lib.sts_format_csv.argtypes = [ctypes.c_char_p, LL, ctypes.c_void_p,
                                       LL, LL, ctypes.c_void_p]
        lib.sts_parse_csv.restype = LL
        lib.sts_parse_csv.argtypes = [ctypes.c_char_p, LL, LL, LL,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.POINTER(LL)]
    return lib

def _escape_key(key: str) -> str:
    """RFC-4180 quoting for keys holding a comma or a quote; plain keys
    are written bare.  A newline cannot live in a line-per-series file,
    so such a key is refused."""
    if "\n" in key or "\r" in key:
        raise ValueError(
            f"series key {key!r} contains a newline, which the "
            "line-per-series CSV contract cannot represent")
    if "," in key or '"' in key:
        return '"' + key.replace('"', '""') + '"'
    return key


def _split_key(line: str) -> tuple:
    """Split ``key,rest`` honoring :func:`_escape_key`'s quoting.  A
    leading quote that does not parse as well-formed quoting falls back
    to the bare first-comma split."""
    if not line.startswith('"'):
        key, _, rest = line.partition(",")
        return key, rest
    i = 1
    out = []
    while i < len(line):
        if line[i] == '"':
            if i + 1 < len(line) and line[i + 1] == '"':
                out.append('"')
                i += 2
                continue
            if i + 1 == len(line) or line[i + 1] == ",":
                return "".join(out), line[i + 2:]
            break                      # quote not closing the field: bare key
        out.append(line[i])
        i += 1
    key, _, rest = line.partition(",")
    return key, rest


def _unquote_key(token: str) -> str:
    """Decode one raw key token as :func:`_split_key` would."""
    if not token.startswith('"'):
        return token
    return _split_key(token + ",")[0]


def _write_index(panel: Panel, path: str) -> None:
    with open(os.path.join(path, CSV_INDEX_FILE), "w") as f:
        f.write(panel.index.to_string())


@_metrics.instrumented("io.save_csv")
def save_csv(panel: Panel, path: str) -> None:
    """Write ``path/data.csv`` (one ``key,v0,v1,...`` row per series) and
    the ``path/timeIndex`` sidecar.  The values, copied to the host as
    float64, are written in shortest round-trip decimals by the native
    codec, or as ``%.17g`` by the Python path when the codec cannot be
    built; either reads back bit-exactly through either loader.  A
    failure of the native codec raises."""
    os.makedirs(path, exist_ok=True)
    values = np.ascontiguousarray(panel.values.cpu().numpy(),
                                  dtype=np.float64)
    esc = [_escape_key(str(key)) for key in panel.keys]
    lib = fastcsv()
    if lib is not None:
        keys_blob = "\n".join(esc).encode()
        rows, cols = values.shape
        out = ctypes.create_string_buffer(
            len(keys_blob) + rows * (cols * 33 + 2) + 1)
        n = lib.sts_format_csv(keys_blob, len(keys_blob),
                               values.ctypes.data_as(ctypes.c_void_p),
                               rows, cols, out)
        if n < 0:
            raise ValueError(
                f"the native CSV codec failed to format {rows} series "
                f"(fewer keys than rows, or a value it cannot write)")
        with open(os.path.join(path, CSV_DATA_FILE), "wb") as f:
            f.write(memoryview(out)[:n])
        _write_index(panel, path)
        _metrics.inc("io.csv_codec_native")
        return
    buf = _io.StringIO()
    np.savetxt(buf, values, delimiter=",", fmt="%.17g")
    with open(os.path.join(path, CSV_DATA_FILE), "w") as f:
        f.writelines(key + "," + row + "\n"
                     for key, row in zip(esc, buf.getvalue().splitlines()))
    _write_index(panel, path)
    _metrics.inc("io.csv_codec_python")


def _parse_native(lib, raw: bytes):
    """``(keys, values)`` of a ``data.csv`` by the native codec."""
    # the width comes from the first non-blank line, as the C parser and
    # the Python path skip blank lines
    first = next(line for line in
                 (b.decode().rstrip("\r") for b in raw.split(b"\n")) if line)
    width = _split_key(first)[1].count(",") + 1
    rows_cap = raw.count(b"\n") + 1
    values = np.empty((rows_cap, width), np.float64)
    spans = np.empty((rows_cap, 2), np.int64)
    err_row = ctypes.c_longlong(-1)
    n = lib.sts_parse_csv(raw, len(raw), rows_cap, width,
                          values.ctypes.data_as(ctypes.c_void_p),
                          spans.ctypes.data_as(ctypes.c_void_p),
                          ctypes.byref(err_row))
    if n < 0:
        what = ("has a malformed or empty numeric field" if n == -1
                else f"does not have {width} values" if n == -2
                else "overflowed the parser's row estimate")
        raise ValueError(
            f"corrupt data.csv: series row {int(err_row.value)} {what}")
    # spans are byte offsets: slice the bytes, then decode
    keys = [_unquote_key(raw[a:b].decode()) for a, b in spans[:n]]
    return keys, values[:n]


def _parse_python(raw: bytes):
    """``(keys, values)`` of a ``data.csv`` in Python: keys split per line,
    then every numeric token through numpy's string to float64 cast,
    which rounds correctly (as ``float()``: out-of-range tokens overflow
    to +/-inf and underflow to +/-0).  A truncated row or an empty or
    malformed field raises."""
    keys, tokens = [], []
    width = None
    for line in raw.decode().split("\n"):
        line = line.rstrip("\r")
        if not line:
            continue
        key, rest = _split_key(line)
        fields = rest.split(",")
        if width is None:
            width = len(fields)
        elif len(fields) != width:
            raise ValueError(
                f"corrupt data.csv: series {key!r} has {len(fields)} "
                f"values, first series has {width}")
        if "" in fields:
            raise ValueError(
                f"corrupt data.csv: series {key!r} has an empty field")
        keys.append(key)
        tokens.extend(fields)
    try:
        values = np.array(tokens).astype(np.float64)
    except ValueError as e:
        raise ValueError(
            f"corrupt data.csv: a numeric field failed to parse ({e})") \
            from e
    return keys, values.reshape(len(keys), width or 0)


@_metrics.instrumented("io.load_csv")
def load_csv(path: str, device=None) -> Panel:
    """Inverse of :func:`save_csv`: the panel on ``device`` (``None``
    means CUDA, float32 there; on the CPU float64).  Corruption raises on
    both codec paths: a truncated row or an empty field is an error, not
    NaN (real NaNs travel as the token ``nan``)."""
    with open(os.path.join(path, CSV_INDEX_FILE)) as f:
        index = dtindex.from_string(f.read().strip())
    with open(os.path.join(path, CSV_DATA_FILE), "rb") as f:
        raw = f.read()
    if not raw.strip():
        return Panel(index, np.zeros((0, len(index))), [], device=device)
    lib = fastcsv()
    if lib is not None:
        keys, values = _parse_native(lib, raw)
        _metrics.inc("io.csv_codec_native")
    else:
        keys, values = _parse_python(raw)
        _metrics.inc("io.csv_codec_python")
    _metrics.inc("io.csv_series_loaded", len(keys))
    _metrics.inc("io.csv_bytes_read", len(raw))
    return Panel(index, values, keys, device=device)


# ---------------------------------------------------------------------------
# Parquet
# ---------------------------------------------------------------------------

@_metrics.instrumented("io.save_parquet")
def save_parquet(panel: Panel, path: str,
                 ts_col: str = "timestamp", key_col: str = "key",
                 value_col: str = "value") -> None:
    """Write the observations DataFrame to parquet and the ``<path>.idx``
    index sidecar."""
    df = panel.to_observations_dataframe(ts_col, key_col, value_col)
    df.to_parquet(path, index=False)
    with open(path + ".idx", "w") as f:
        f.write(panel.index.to_string())


@_metrics.instrumented("io.load_parquet")
def load_parquet(path: str, ts_col: str = "timestamp", key_col: str = "key",
                 value_col: str = "value", device=None) -> Panel:
    """Inverse of :func:`save_parquet`."""
    import pandas as pd
    with open(path + ".idx") as f:
        index = dtindex.from_string(f.read().strip())
    df = pd.read_parquet(path)
    return Panel.from_observations(df, index, ts_col, key_col, value_col,
                                   device=device)


# ---------------------------------------------------------------------------
# Yahoo finance CSV
# ---------------------------------------------------------------------------

def yahoo_string_to_panel(text: str, key_prefix: str = "",
                          zone: Optional[str] = None, device=None) -> Panel:
    """Parse Yahoo-finance CSV text (``Date,Open,High,...`` header, rows
    newest first) into a panel keyed ``<prefix><column>``, the rows in
    chronological order, each date at the start of its day."""
    import pandas as pd
    lines = [ln for ln in text.strip().split("\n") if ln]
    labels = [key_prefix + c for c in lines[0].split(",")[1:]]
    dates, rows = [], []
    for line in lines[1:]:
        tokens = line.split(",")
        dates.append(tokens[0])
        rows.append([float(t) for t in tokens[1:]])
    order = np.argsort(np.asarray(dates))
    nanos = pd.DatetimeIndex(np.asarray(dates)[order]).as_unit("ns") \
        .asi8.astype(np.int64)
    data = np.asarray(rows, dtype=np.float64)[order].T   # (n_cols, n_obs)
    return Panel(dtindex.irregular(nanos, zone), data, labels, device=device)


@_metrics.instrumented("io.yahoo_file")
def yahoo_file_to_panel(path: str, key_prefix: Optional[str] = None,
                        zone: Optional[str] = None, device=None) -> Panel:
    """Parse one Yahoo CSV file; the key prefix defaults to the file's
    name."""
    if key_prefix is None:
        key_prefix = os.path.basename(path)
    with open(path) as f:
        return yahoo_string_to_panel(f.read(), key_prefix, zone,
                                     device=device)


@_metrics.instrumented("io.yahoo_files")
def yahoo_files_to_panel(path: str, zone: Optional[str] = None,
                         device=None) -> Panel:
    """Load a directory of Yahoo CSV files into one panel: the files'
    indices are unioned and each file's series rebased onto the union,
    NaN where a file has no observation."""
    import torch

    from .time.union import union as index_union

    names = sorted(n for n in os.listdir(path)
                   if n.lower().endswith(".csv"))
    if not names:
        raise ValueError(f"no .csv files under {path!r}")
    panels = [yahoo_file_to_panel(os.path.join(path, n), zone=zone,
                                  device=device) for n in names]
    if len(panels) == 1:
        return panels[0]
    target = index_union([p.index for p in panels], zone)
    rebased = [p.with_index(target) for p in panels]
    return Panel(target, torch.cat([p.values for p in rebased]),
                 [k for p in rebased for k in p.keys], device=device)
