"""Report tables of the port (port of :func:`repro.analysis.report.
corner_table`; the dry-run and roofline tables are TPU records and are not
ported)."""
from __future__ import annotations


def corner_table(corner_energy_pj: dict, tokens: int = 0) -> str:
    """Per-device-corner EMT energy breakdown (heterogeneous placements).

    `corner_energy_pj`: {corner label: pJ} — the engine's `corner_energy_pj`
    accumulator or an aux tree's `{name: c["energy_pj"]}`.  Rows are sorted by
    energy; the total line is the exact sum (per-corner accounting books every
    crossbar read under exactly one corner)."""
    total = sum(corner_energy_pj.values())
    hdr = "| corner | energy uJ | share |" + (" uJ/token |" if tokens else "")
    rows = [hdr, "|" + "---|" * (4 if tokens else 3)]
    for name, pj in sorted(corner_energy_pj.items(), key=lambda kv: -kv[1]):
        row = (f"| {name} | {pj * 1e-6:.4f} | "
               f"{pj / total if total else 0.0:6.1%} |")
        if tokens:
            row += f" {pj * 1e-6 / tokens:.5f} |"
        rows.append(row)
    row = f"| total | {total * 1e-6:.4f} | 100.0% |"
    if tokens:
        row += f" {total * 1e-6 / max(tokens, 1):.5f} |"
    rows.append(row)
    return "\n".join(rows)
