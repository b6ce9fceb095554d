"""Convergence report from a trainer log (port of the JAX package's root
``tools/convergence_report.py``).

Parses the per-epoch ``epoch N: key=val ...`` lines that the port's
trainers print (``train/stage1_ae.py``, ``train/stage2_predictor.py``, the
same lines as the JAX package's), samples the monitored metric on a fixed
stride, fits least-squares slopes over trailing windows of the run, and
writes a markdown table and a JSON (the JAX tool's keys), so that "has the
curve flattened?" is answered by an artefact.

    python -m npvp_tpu_torch.tools.convergence_report <train_log> [...] \\
        [--metric loss_val] [--stride 25] [--out <md>] [--out_dir DIR]

``--out`` names the markdown (a sibling ``.json`` is written too); else
``--out_dir`` gets ``convergence_<metric>.{md,json}``; with neither the
markdown goes to stdout. ``--device`` is taken as every report tool takes
it (default cuda, which raises without a card); parsing a log uses no
device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

from npvp_tpu_torch.core.device import resolve_device
from npvp_tpu_torch.tools._cli import add_run_args

LINE = re.compile(r"^epoch (\d+):((?: \S+=\S+)+)\s*$")


def parse_log(path):
    """-> {epoch: {metric: value}}; a later line of the same epoch wins (a
    resumed run replays its resumed epoch)."""
    rows = {}
    for line in pathlib.Path(path).read_text().splitlines():
        m = LINE.match(line.strip())
        if not m:
            continue
        metrics = {}
        for item in m.group(2).split():
            k, _, v = item.partition("=")
            try:
                metrics[k] = float(v)
            except ValueError:
                continue
        rows[int(m.group(1))] = metrics
    return rows


def slope_per_100(points):
    """Least-squares slope of value against epoch, per 100 epochs."""
    if len(points) < 2:
        return float("nan")
    n = len(points)
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    mx, my = sum(xs) / n, sum(ys) / n
    denom = sum((x - mx) ** 2 for x in xs)
    if denom == 0:
        return float("nan")
    return 100.0 * sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom


def report(rows, metric, stride):
    epochs = sorted(rows)
    pts = [(e, rows[e][metric]) for e in epochs if metric in rows[e]]
    if not pts:
        raise SystemExit(f"metric '{metric}' not found; available: "
                         f"{sorted(rows[epochs[-1]]) if epochs else []}")
    last = pts[-1][0]
    sampled = [p for p in pts if p[0] % stride == 0 or p[0] == last]
    best = min(pts, key=lambda p: p[1])
    # slopes over trailing windows of max(stride * 4, last // 3) epochs
    win = max(stride * 4, (last + 1) // 3)
    segs = []
    for hi in (last - 2 * win, last - win, last):
        lo = hi - win
        seg = [p for p in pts if lo < p[0] <= hi]
        if len(seg) >= 2:
            segs.append(((max(lo, 0), hi), slope_per_100(seg)))
    return {"metric": metric, "epochs": last + 1,
            "best_epoch": best[0], "best_value": best[1],
            "final_value": pts[-1][1],
            "sampled": sampled,
            "slopes_per_100": [{"epochs": list(s[0]), "slope": s[1]}
                               for s in segs]}


def to_markdown(rep, log_path, overlap_notes=()):
    lines = [f"# Convergence report — `{rep['metric']}`", "",
             f"Source: `{log_path}` ({rep['epochs']} epochs; generated by "
             "`python -m npvp_tpu_torch.tools.convergence_report`).", ""]
    for note in overlap_notes:
        lines += [f"> {note}", ""]
    lines += [
        f"Best epoch: **{rep['best_epoch']}** "
        f"({rep['metric']} = {rep['best_value']:.5f}); "
        f"final = {rep['final_value']:.5f}.", "",
        "| epoch | " + rep["metric"] + " |", "|---|---|"]
    lines += [f"| {e} | {v:.5f} |" for e, v in rep["sampled"]]
    lines += ["", "Least-squares slope per 100 epochs (trailing windows):",
              ""]
    for s in rep["slopes_per_100"]:
        lines.append(f"- epochs {s['epochs'][0]}–{s['epochs'][1]}: "
                     f"**{s['slope']:+.5f}**")
    lines += ["",
              "A slope within noise of zero in the final window means the "
              "run converged at its budget; a persistently negative slope "
              "means the committed numbers understate the recipe."]
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log", nargs="+",
                    help="trainer log(s); the logs of a run continued "
                         "from a checkpoint merge, a later log's epochs "
                         "winning")
    ap.add_argument("--metric", default="loss_val")
    ap.add_argument("--stride", type=int, default=25)
    ap.add_argument("--out", default=None,
                    help="markdown path; a sibling .json is written too")
    add_run_args(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    rows = {}
    overlap_notes = []
    for log in args.log:
        new = parse_log(log)
        overlap = sorted(set(rows) & set(new))
        if overlap:
            # logs merge in argument order: a mis-ordered call (stale
            # values winning) is named in the report
            note = (f"`{log}` overrides {len(overlap)} earlier-log epoch(s) "
                    f"{overlap[0]}–{overlap[-1]} — logs merge later-wins in "
                    "argument order; pass them chronologically")
            print(f"[convergence_report] {note}", file=sys.stderr)
            overlap_notes.append(note)
        rows.update(new)
    rep = report(rows, args.metric, args.stride)
    md = to_markdown(rep, " + ".join(args.log), overlap_notes)
    out = (pathlib.Path(args.out) if args.out else
           pathlib.Path(args.out_dir) / f"convergence_{args.metric}.md"
           if args.out_dir else None)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(md)
        out.with_suffix(".json").write_text(json.dumps(rep, indent=1))
        print(f"wrote {out} and {out.with_suffix('.json')}")
    else:
        sys.stdout.write(md)


if __name__ == "__main__":
    main(sys.argv[1:])
