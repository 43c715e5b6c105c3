"""RTTOV-gb text-protocol interop (prof_plev.dat + printed output report).

The reference serializes profiles to a fixed-width text file
(`write1profile2str`, /root/reference/python_src/proc/
RTTOV_gb_processing.py:80-100), patches NPROF/NLEVELS into the vendor run
script (:167-189), and scrapes TBs, transmittances and K-matrix Jacobians
out of the printed report with a four-state-machine parser (:193-305).

This module implements both directions:

  * `format_profile` / `write_profiles_dat` — byte-compatible profile
    serialization (so reference-side RTTOV-gb installs accept our files);
  * `parse_profiles_dat` — read profiles the reference wrote;
  * `write_output_report` — emit a report in the layout the reference's
    parser consumes (TB/transmittance blocks, level-transmittance table with
    its >=100-level column quirk, per-channel Jacobian blocks);
  * `parse_output_report` — read reports, ours or RTTOV-gb's;
  * `simulate_profiles_dat` — the drop-in path: prof_plev.dat in, native LBL
    forward + autodiff K-matrix, report out.  An existing reference
    deployment can point its `run_apschera.sh` at this and delete Fortran.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

N_CHANNELS = 14
N_LEVELS = 180

_TB_HEADER = "CALCULATED BRIGHTNESS TEMPERATURES (K):"
_TRANS_HEADER = "CALCULATED SURFACE TO SPACE TRANSMITTANCE:"
_LEVTRANS_HEADER = "Level to surface transmittances for channels"


@dataclasses.dataclass
class RttovProfile:
    """One profile of the text protocol (arrays TOA -> ground, like the
    reference's `Level_*` variables)."""

    p_hpa: np.ndarray
    t_k: np.ndarray
    ppmv: np.ndarray
    liquid_kgkg: np.ndarray
    height_km: float = 0.0
    lat_deg: float = 50.0
    zenith_deg: float = 0.0


def format_profile(prof: RttovProfile, clear_sky: bool = True) -> str:
    """Fixed-width serialization, byte-compatible with `write1profile2str`
    (RTTOV_gb_processing.py:84-100): p column, T column, ppmv column, liquid
    column, then surface T/p, altitude/latitude, zenith angle."""
    liquid = np.zeros_like(prof.liquid_kgkg) if clear_sky else prof.liquid_kgkg
    parts = []
    parts += [f"{v:8.4f}\n" for v in np.asarray(prof.p_hpa)]
    parts += [f"{v:6.3f}\n" for v in np.asarray(prof.t_k)]
    parts += [f"{v:9.4f}\n" for v in np.asarray(prof.ppmv)]
    parts += [f"{v:12.6E}\n" for v in np.asarray(liquid)]
    parts.append(f"{prof.t_k[-1]:10.4f}{prof.p_hpa[-1]:10.2f}\n")
    parts.append(f"{prof.height_km:6.3f}{prof.lat_deg:6.1f}\n")
    parts.append(f"{prof.zenith_deg:6.1f}\n")
    return "".join(parts)


def write_profiles_dat(path: str, profiles: list[RttovProfile],
                       clear_sky: bool = True) -> None:
    with open(path, "w") as fh:
        for prof in profiles:
            fh.write(format_profile(prof, clear_sky=clear_sky))


def parse_profiles_dat(path: str, n_levels: int = N_LEVELS) -> list[RttovProfile]:
    """Inverse of `write_profiles_dat`; accepts files written by the
    reference (same column order and trailer lines)."""
    with open(path) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    per_prof = 4 * n_levels + 3
    if len(lines) % per_prof:
        raise ValueError(
            f"{path}: {len(lines)} lines is not a multiple of {per_prof} "
            f"(4*{n_levels} columns + 3 trailer lines per profile)")
    out = []
    for base in range(0, len(lines), per_prof):
        cols = [np.array([float(lines[base + j * n_levels + i]) for i in range(n_levels)])
                for j in range(4)]
        surf = lines[base + 4 * n_levels].split()
        geo = lines[base + 4 * n_levels + 1].split()
        zen = float(lines[base + 4 * n_levels + 2])
        prof = RttovProfile(p_hpa=cols[0], t_k=cols[1], ppmv=cols[2],
                            liquid_kgkg=cols[3], height_km=float(geo[0]),
                            lat_deg=float(geo[1]), zenith_deg=zen)
        del surf  # surface T/p are duplicates of the last level values
        out.append(prof)
    return out


def patch_run_script(text: str, nprof: int, nlevels: int) -> str:
    """The reference rewrites the NPROF/NLEVELS assignment lines of the
    vendor run script per batch (RTTOV_gb_processing.py:176-183); do the
    same by pattern rather than by line number."""
    text = re.sub(r"(?m)^\s*NPROF=.*$", f"NPROF={nprof}", text)
    return re.sub(r"(?m)^\s*NLEVELS=.*$", f"NLEVELS={nlevels}", text)


# ---------------------------------------------------------------------------
# Output report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RttovResult:
    """Per-profile outputs of a K-run (what the reference's parser extracts:
    RTTOV_gb_processing.py:193-305)."""

    tb: np.ndarray                  # (14,)
    total_transmittance: np.ndarray  # (14,)
    level_transmittance: np.ndarray  # (L, 14), level-to-surface
    jacobians: np.ndarray           # (L, 14, 4): d TB / d (p, T, ppmv, liq)


def _two_line_block(values: np.ndarray) -> str:
    v = np.asarray(values)
    half = (len(v) + 1) // 2
    fmt = lambda row: "  " + " ".join(f"{x:12.5f}" for x in row) + "\n"
    return fmt(v[:half]) + fmt(v[half:])


def write_output_report(path: str, results: list[RttovResult]) -> None:
    """Emit the printed-report layout the reference's state-machine parser
    reads back (including the level-transmittance table quirk where rows
    past 99 drop the level index — the parser indexes those rows by
    position, RTTOV_gb_processing.py:268-284)."""
    with open(path, "w") as fh:
        for i, res in enumerate(results):
            nlev = res.level_transmittance.shape[0]
            fh.write(f" Profile      {i + 1}\n\n")
            fh.write(f" {_TB_HEADER}\n")
            fh.write(_two_line_block(res.tb))
            fh.write(f" {_TRANS_HEADER}\n")
            fh.write(_two_line_block(res.total_transmittance))

            fh.write(f" {_LEVTRANS_HEADER} 1-10\n")
            fh.write("  level" + "".join(f"  ch{c + 1:02d}" for c in range(10)) + "\n")
            for j in range(nlev):
                row = " ".join(f"{x:10.6f}" for x in res.level_transmittance[j, :10])
                prefix = f"{j + 1:5d} " if j < 99 else " "
                fh.write(prefix + row + "\n")
            fh.write(f" {_LEVTRANS_HEADER} 11-14\n")
            fh.write("  level" + "".join(f"  ch{c + 11:02d}" for c in range(4)) + "\n")
            for j in range(nlev):
                row = " ".join(f"{x:10.6f}" for x in res.level_transmittance[j, 10:])
                fh.write(f"{j + 1:5d} " + row + "\n")

            for c in range(res.jacobians.shape[1]):
                fh.write(f" Channel        {c + 1}\n")
                fh.write("  level     d/dp          d/dT          d/dppmv       d/dliq\n")
                fh.write("  -----\n")
                for j in range(nlev):
                    vals = " ".join(f"{x:14.6E}" for x in res.jacobians[j, c])
                    fh.write(f"{j + 1:5d} {vals}\n")
            fh.write("\n")


def parse_output_report(path: str, n_levels: int = N_LEVELS,
                        n_channels: int = N_CHANNELS) -> list[RttovResult]:
    """Parse a report (ours or RTTOV-gb's) back into per-profile results.

    Semantics match the reference parser (RTTOV_gb_processing.py:193-305):
    headers arm a capture, two lines of numbers follow the TB/transmittance
    headers, the level-transmittance table carries channels 1-10 then 11-14,
    and each `Channel n` block holds two header lines plus one row per level.
    """
    with open(path) as fh:
        lines = fh.read().splitlines()

    results: list[RttovResult] = []
    cur: RttovResult | None = None

    def numbers(s: str) -> list[float]:
        return [float(tok) for tok in s.split() if tok not in ("**",)]

    i = 0
    while i < len(lines):
        line = lines[i]
        if "Profile      " in line:
            cur = RttovResult(
                tb=np.full(n_channels, np.nan),
                total_transmittance=np.full(n_channels, np.nan),
                level_transmittance=np.full((n_levels, n_channels), np.nan),
                jacobians=np.full((n_levels, n_channels, 4), np.nan))
            results.append(cur)
        elif _TB_HEADER in line and cur is not None:
            cur.tb[:] = numbers(lines[i + 1]) + numbers(lines[i + 2])
            i += 2
        elif _TRANS_HEADER in line and cur is not None:
            cur.total_transmittance[:] = numbers(lines[i + 1]) + numbers(lines[i + 2])
            i += 2
        elif _LEVTRANS_HEADER in line and cur is not None:
            i += 2  # skip the column-header line
            for j in range(n_levels):
                vals = numbers(lines[i + j])
                if len(vals) in (4, 5):       # channels 11-14 block
                    cur.level_transmittance[j, 10:] = vals[-4:]
                elif len(vals) in (10, 11):   # channels 1-10 block
                    cur.level_transmittance[j, :10] = vals[-10:]
                else:
                    break
            i += n_levels - 1
        elif re.search(r"Channel\s+\d+\s*$", line) and cur is not None:
            ch = int(line.split()[-1]) - 1
            i += 3  # two header lines after the Channel line
            for j in range(n_levels):
                vals = numbers(lines[i + j])
                cur.jacobians[j, ch, :] = vals[-4:]
            i += n_levels - 1
        i += 1
    return results


# ---------------------------------------------------------------------------
# Drop-in simulation
# ---------------------------------------------------------------------------

def simulate_profiles_dat(in_path: str, out_path: str,
                          n_levels: int = N_LEVELS, model: str = "R24",
                          want_jacobians: bool = True) -> list[RttovResult]:
    """Act as the RTTOV-gb executable: read prof_plev.dat, run the native
    forward (+ autodiff K-matrix), write the output report.

    The reference's zenith angle is 90 - elevation (RTTOV_gb_processing.py:
    98); profiles arrive TOA->ground and are flipped to the framework's
    ground->top convention here.
    """
    import jax.numpy as jnp

    from ..constants import hatpro, physics as phys
    from ..models import jacobians as jac_mod
    from ..models import lbl
    from ..ops import thermo

    profs = parse_profiles_dat(in_path, n_levels=n_levels)
    results = []
    for prof in profs:
        # TOA->ground -> ground->top, ppmv -> vapor density.
        p_np = prof.p_hpa[::-1].copy()
        t_np = prof.t_k[::-1].copy()
        ppmv_np = prof.ppmv[::-1].copy()
        liq_np = prof.liquid_kgkg[::-1].copy()
        e_np = p_np * ppmv_np * 1e-6
        mr_np = np.asarray(thermo.e_to_mr(e_np, p_np))
        # Hypsometric heights above station altitude (the text protocol
        # carries no z column; RTTOV-gb, too, reconstructs the grid from p).
        tv = np.asarray(thermo.virtual_temperature(t_np, mr_np))
        tv_mid = 0.5 * (tv[:-1] + tv[1:])
        dz = phys.RD / phys.G0 * tv_mid * np.log(p_np[:-1] / p_np[1:])
        z_np = prof.height_km * 1000.0 + np.concatenate([[0.0], np.cumsum(dz)])
        rho_air = np.asarray(thermo.density_moist(p_np, t_np, mr_np))
        lwc_np = liq_np * rho_air * 1000.0  # kg/kg -> g/m^3

        p, t = jnp.asarray(p_np), jnp.asarray(t_np)
        rho = jnp.asarray(thermo.e_to_rho(e_np, t_np))
        z, lwc = jnp.asarray(z_np), jnp.asarray(lwc_np)
        elev = 90.0 - prof.zenith_deg
        cfg = lbl.LBLConfig(model=model, elevations_deg=(float(elev),),
                            outputs=("tb", "tau_total", "trans_level"))
        out = lbl.forward_batch({"z": z[None], "p": p[None], "t": t[None],
                                 "rho": rho[None], "lwc": lwc[None]}, cfg)
        tb = np.asarray(out["tb"])[0, 0]
        tau = np.asarray(out["tau_total"])[0, 0]
        # trans_level is (F, L) ground->top; the report is TOA->ground rows.
        trans_level = np.asarray(out["trans_level"])[0, 0].T[::-1]

        if want_jacobians:
            f = jnp.asarray(hatpro.HATPRO_FREQS_GHZ)
            k = jac_mod.kmatrix_single(z, p, t, rho, lwc, f, float(elev),
                                       model, wrt=("t", "rho", "lwc"))
            kppmv = jac_mod.kmatrix_ppmv_from_rho(k["rho"], p, t)
            # (F, L) ground->top -> (L, F) TOA->ground; the p-Jacobian is not
            # a state variable of the native forward (pressure defines the
            # grid), reported as zero like clear-sky liquid columns.
            kt = np.asarray(k["t"]).T[::-1]
            kq = np.asarray(kppmv).T[::-1]
            kl = np.asarray(k["lwc"]).T[::-1]
            jacs = np.stack([np.zeros_like(kt), kt, kq, kl], axis=-1)
        else:
            jacs = np.zeros((n_levels, N_CHANNELS, 4))

        results.append(RttovResult(
            tb=tb, total_transmittance=np.exp(-tau),
            level_transmittance=trans_level, jacobians=jacs))
    write_output_report(out_path, results)
    return results
