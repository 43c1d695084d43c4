"""Catalog ingestion and artifact IO (port of
``lumfuncmcmc_tpu/utils/io.py``, numpy, unchanged in behaviour).

- :func:`read_catalog` reads whitespace-delimited ascii with a header
  row (``Field``, ``z``, ``{line}_flux[_e]`` in 1e-17 cgs or
  ``{line}_lum[_e]``), applies the per-field completeness cut and
  builds the per-source field index; plain tables go through the C
  reader of :mod:`lumfuncmcmc_tpu_torch.native`.
- :func:`write_fixed_width_two_line` / :func:`read_fixed_width_two_line`
  produce/consume astropy's ``ascii.fixed_width_two_line`` format.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.ops.completeness import fleming_root_logf_np


def _looks_fixed_width(path: str) -> bool:
    """Cheap peek: is the second content line a dash ruler?"""
    try:
        with open(path) as fh:
            seen = 0
            for ln in fh:
                s = ln.strip()
                if not s or s.startswith("#"):
                    continue
                seen += 1
                if seen == 2:
                    return set(s.replace(" ", "")) <= {"-"}
    except OSError:
        pass
    return False


def read_ascii_table(path: str) -> dict:
    """Ascii table -> dict of columns (float where possible, else string).

    Handles both plain whitespace-delimited tables with a header line and
    the ``fixed_width_two_line`` layout. For the latter, column spans are
    derived from the dash runs of the second line — required because
    column names may contain spaces (the reference writes LaTeX parameter
    names like ``$\\log L_*$`` as column headers). Lines starting with
    '#' are skipped.

    Plain tables go through the native C parser when available
    (:mod:`lumfuncmcmc_tpu_torch.native` — ~10x the Python reader on a
    1e6-row catalog, bitwise-identical floats); fixed-width layouts and files
    the C parser declines (mixed-type columns) fall through to the
    Python path below.
    """
    if not _looks_fixed_width(path):
        from lumfuncmcmc_tpu_torch.native import read_table_fast
        fast = read_table_fast(path)
        if fast is not None:
            return fast
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh
                 if ln.strip() and not ln.lstrip().startswith("#")]
    body = lines[1:]
    if body and set(body[0].replace(" ", "")) <= {"-"}:
        # fixed_width_two_line: slice by the dash-run spans
        dash = body[0]
        spans, start = [], None
        for i, ch in enumerate(dash + " "):
            if ch == "-" and start is None:
                start = i
            elif ch != "-" and start is not None:
                spans.append((start, i))
                start = None
        header = [lines[0][a:b].strip() for a, b in spans]
        rows = []
        for ln in body[1:]:
            rows.append([ln[a:b].strip() if b <= len(ln)
                         else ln[a:].strip() for a, b in spans])
    else:
        header = lines[0].split()
        rows = []
        for ln in body:
            parts = ln.split()
            if len(parts) != len(header):
                raise ValueError(
                    f"{path}: row has {len(parts)} fields, header has "
                    f"{len(header)}")
            rows.append(parts)
    cols = {name: [r[i] for r in rows] for i, name in enumerate(header)}
    out = {}
    for name, vals in cols.items():
        try:
            out[name] = np.asarray(vals, dtype=np.float64)
        except ValueError:
            out[name] = np.asarray(vals)
    return out


def write_fixed_width_two_line(path: str, cols: dict, formats=None):
    """astropy ``ascii.fixed_width_two_line``-compatible writer.

    Layout: header row, a row of dashes per column, then space-separated
    fixed-width data rows.
    """
    formats = formats or {}
    names = list(cols.keys())
    rendered = {}
    for nm in names:
        fmt = formats.get(nm)
        vals = cols[nm]
        if fmt:
            rendered[nm] = [fmt % v for v in vals]
        elif isinstance(vals, np.ndarray) and vals.dtype.kind == "f":
            # a catalog-length column (10^6 rows): repr of the Python
            # floats in one pass, as _render would give each
            rendered[nm] = list(map(repr, vals.astype(np.float64).tolist()))
        else:
            rendered[nm] = [_render(v) for v in vals]
    widths = {nm: max(len(nm), max((len(s) for s in rendered[nm]),
                                   default=0))
              for nm in names}
    with open(path, "w") as fh:
        fh.write(" ".join(nm.rjust(widths[nm]) for nm in names) + "\n")
        fh.write(" ".join("-" * widths[nm] for nm in names) + "\n")
        padded = [[s.rjust(widths[nm]) for s in rendered[nm]]
                  for nm in names]
        fh.writelines(" ".join(row) + "\n" for row in zip(*padded))


def _render(v) -> str:
    if isinstance(v, (bytes, str)):
        return str(v)
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return repr(float(v))


def read_fixed_width_two_line(path: str) -> dict:
    return read_ascii_table(path)


def align_field_params(cfg: LFConfig, field_names):
    """Align the per-field ``Flim``/``Omega_0`` config entries with the
    catalog's (sorted-unique) field names.

    Matching is BY NAME against ``cfg.survey_fields`` whenever every
    catalog field is known there: the reference pairs positionally
    (``run_lumfuncmcmc.py:174`` + ``defineFlimOmArr``), which silently
    mismatches subsets — a COSMOS+UDS catalog would be cut at AEGIS's
    and COSMOS's flux limits. Unknown field names fall back to the
    positional truncation (with a printed notice when entries are
    dropped, matching the previous behavior).
    """
    names = [str(n) for n in field_names]
    known = [str(n) for n in (cfg.survey_fields or ())]
    if known and all(n in known for n in names) and (
            len(cfg.Flim) == len(known) == len(cfg.Omega_0)):
        ix = [known.index(n) for n in names]
        if ix != list(range(len(cfg.Flim))):
            print(f"Matched {len(names)} catalog fields to configured "
                  f"Flim/Omega_0 entries by name: "
                  + ", ".join(f"{n}={cfg.Flim[i]}"
                              for n, i in zip(names, ix)))
        return cfg.replace(Flim=tuple(cfg.Flim[i] for i in ix),
                           Omega_0=tuple(cfg.Omega_0[i] for i in ix),
                           survey_fields=tuple(names))
    if len(names) < len(cfg.Flim):
        print(f"Catalog has {len(names)} fields not matching "
              f"cfg.survey_fields; using the first {len(names)} of "
              f"{len(cfg.Flim)} configured Flim/Omega_0 entries")
        return cfg.replace(Flim=tuple(cfg.Flim[:len(names)]),
                           Omega_0=tuple(cfg.Omega_0[:len(names)]),
                           survey_fields=tuple(names))
    return cfg.replace(survey_fields=tuple(names))


def read_catalog(filename: str, cfg: LFConfig, dust_fn: Optional[str] = None):
    """Read a multi-field catalog and apply per-field completeness cuts.

    Returns a dict with concatenated ``z``, ``field_id``, ``field_names``
    and either ``flux``/``flux_e`` (1e-17 cgs) or ``lum``/``lum_e``
    (log erg/s), plus optional dust-join outputs (``AHa``, ``AHa_err``,
    ``SFR_MC``, ``SFR_MC_e`` — coefficients 2.07*2.66 for Ha and
    2.07*3.46 otherwise, as in ``run_lumfuncmcmc.py:222-223``).
    """
    tab = read_ascii_table(filename)
    fields = tab["Field"].astype(str)
    zfull = tab["z"]
    field_names = np.unique(fields)
    nf = len(field_names)
    if nf > len(cfg.Flim) or nf > len(cfg.Omega_0):
        raise ValueError(
            f"{filename}: catalog has {nf} unique fields "
            f"({', '.join(field_names)}) but the config provides only "
            f"{len(cfg.Flim)} Flim / {len(cfg.Omega_0)} Omega_0 entries "
            "— supply one Flim/Omega_0 per field")

    cfg = align_field_params(cfg, field_names)
    if abs(cfg.min_comp_frac) < 1.0e-6:
        roots = np.zeros(nf)  # no cut
    else:
        # Flim and the catalog fluxes share the 1e-17 cgs unit convention
        # (run_lumfuncmcmc.py:174-176 solves in those units directly)
        flims = np.asarray(cfg.Flim[:nf], dtype=np.float64)
        roots = 10.0 ** fleming_root_logf_np(
            np.log10(flims), cfg.alpha, cfg.min_comp_frac, cfg.fcmin)

    line = cfg.line_name
    flux_col, lum_col = f"{line}_flux", f"{line}_lum"
    out = {"field_names": field_names}

    def per_field_select(cond_fn):
        sel_z, sel_fid, sel_idx = [], [], []
        for i, fd in enumerate(field_names):
            cond = (fields == fd) & cond_fn(i)
            sel_z.append(zfull[cond])
            sel_fid.append(np.full(cond.sum(), i, dtype=np.int32))
            sel_idx.append(np.nonzero(cond)[0])
        return (np.concatenate(sel_z), np.concatenate(sel_fid),
                np.concatenate(sel_idx))

    if flux_col in tab:
        fluxfull = tab[flux_col]
        z, fid, idx = per_field_select(lambda i: fluxfull > roots[i])
        flux_e = (tab[f"{flux_col}_e"][idx]
                  if f"{flux_col}_e" in tab else None)
        out.update(z=z, field_id=fid, flux=fluxfull[idx], flux_e=flux_e,
                   lum=None, lum_e=None)
    elif lum_col in tab:
        lumfull = tab[lum_col]
        z, fid, idx = per_field_select(lambda i: lumfull > 0)
        out.update(z=z, field_id=fid, flux=None, flux_e=None,
                   lum=lumfull[idx],
                   lum_e=tab[f"{lum_col}_e"][idx]
                   if f"{lum_col}_e" in tab else None)
    else:
        raise ValueError(
            f"{filename}: needs a '{flux_col}' or '{lum_col}' column")
    out["selected_rows"] = idx

    if dust_fn is not None and os.path.exists(dust_fn):
        dust = read_ascii_table(dust_fn)
        # "|" separator keeps (Field, ID) keys unambiguous — bare
        # concatenation would collide ('A', 11) with ('A1', 1)
        key = [f"{f}|{i}" for f, i in
               zip(dust["Field"].astype(str),
                   dust["ID"].astype(np.int64))]
        ids = tab["ID"].astype(np.int64)
        want = [f"{f}|{i}" for f, i in zip(fields[idx], ids[idx])]
        lookup = {k: i for i, k in enumerate(key)}
        missing = [k for k in want if k not in lookup]
        if missing:
            raise ValueError(
                f"{dust_fn}: no dust row for {len(missing)} of the "
                f"{len(want)} selected sources (e.g. "
                f"{', '.join(missing[:3])}) — the dust table must "
                "cover every source that passes the completeness cut")
        over = np.asarray([lookup[k] for k in want], dtype=np.int64)
        coef = 2.07 * (2.66 if line == "Ha" else 3.46)
        out["AHa"] = coef * dust["E(B-V)"][over]
        out["AHa_err"] = coef * dust["E(B-V)err"][over]
        out["SFR_MC"] = dust["SFR100"][over]
        out["SFR_MC_e"] = dust["SFR100err"][over]
    return out


def artifact_path(outdir: str, kind: str, output_filename: str,
                  cfg: LFConfig, ext=None) -> str:
    """Reference artifact naming: ``{kind}_{base}_nb{n}_nw{n}_ns{n}_mcf{n}``
    (``run_lumfuncmcmc.py:260,292-314``). ``ext=None`` omits the
    extension (plot writers append their own)."""
    base = output_filename.split(".")[0]
    stem = (f"{kind}_{base}_nb{cfg.nbins}_nw{cfg.nwalkers}_ns{cfg.nsteps}"
            f"_mcf{int(100 * cfg.min_comp_frac)}")
    return os.path.join(outdir, stem if ext is None else f"{stem}.{ext}")
