"""Multi-pod dry-run of the port: every (arch x shape) case traced on fake
tensors over a fake process group of 256 (16x16) or 512 (2x16x16) ranks,
per-chip flops, bytes, collectives, peak memory and the roofline terms
against the H100's figures, one JSON file a case.

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --all          # each case in a subprocess

It allocates nothing and needs no card: the process group is fake and set
up before anything else imports the port.
"""
import argparse
import json
import pathlib
import subprocess
import sys

#: --all: cases traced at once, each in a process of its own
JOBS = 4
#: --all: seconds a case may take before it counts as failed
CASE_TIMEOUT_S = 600.0


def _args(argv=None):
    ap = argparse.ArgumentParser(description="dry-run of the port over a fake mesh")
    ap.add_argument("--arch", help="architecture id (see repro_torch.configs.ARCH_IDS)")
    ap.add_argument("--shape", help="input shape id")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh (512 chips)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) x {single,multi} case in subprocesses")
    ap.add_argument("--out", default="experiments/dryrun_torch", help="output dir for JSON")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--rules", default=None,
                    help="JSON dict of sharding-rule overrides (perf experiments)")
    ap.add_argument("--tag", default="", help="suffix for the output filename")
    ap.add_argument("--table", action="store_true",
                    help="print a markdown table of the cases in --out and exit")
    return ap.parse_args(argv)


def table(out: pathlib.Path) -> str:
    """Every (arch x shape) case's per-chip peak GB, whether it fits the
    card and the dominant roofline term, at both meshes, from the JSON files
    in ``out``; a case without its file is marked failed."""
    from repro_torch.launch.dryrun_lib import case_list

    shapes = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    rows = ["| arch | " + " | ".join(f"{s} {m}" for s in shapes for m in ("16x16", "2x16x16"))
            + " |", "|---" * (1 + 2 * len(shapes)) + "|"]
    cases = set(case_list())
    for arch in dict.fromkeys(a for a, _ in case_list()):
        cells = []
        for s in shapes:
            for m in ("16x16", "2x16x16"):
                f = out / f"{arch}__{s}__{m}.json"
                if (arch, s) not in cases:
                    cells.append("—")
                elif not f.exists():
                    cells.append("**failed**")
                else:
                    d = json.loads(f.read_text())
                    fits = "fits" if d["memory"]["fits_hbm"] else "**does not fit**"
                    cells.append(f"{d['memory']['peak_bytes'] / 1e9:.2f} {fits} {d['dominant']}")
        rows.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def _run_all(args, out: pathlib.Path) -> int:
    """Every case in its own subprocess, ``JOBS`` at a time, each stopped
    after ``CASE_TIMEOUT_S``."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.dryrun_lib import case_list

    cases = []
    for arch, shape in case_list():
        for mp in (False, True):
            mesh_tag = "2x16x16" if mp else "16x16"
            if args.skip_existing and (out / f"{arch}__{shape}__{mesh_tag}.json").exists():
                print(f"skip {arch}__{shape}__{mesh_tag}")
                continue
            cases.append((arch, shape, mp, mesh_tag))

    def run(case):
        arch, shape, mp, mesh_tag = case
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", str(out)] + (["--multi-pod"] if mp else [])
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=CASE_TIMEOUT_S)
            return case, r.returncode, r.stdout[-1500:], r.stderr[-3000:]
        except subprocess.TimeoutExpired:
            return case, "timeout", "", f"timed out after {CASE_TIMEOUT_S} s"

    failures = []
    with ThreadPoolExecutor(JOBS) as pool:
        for (arch, shape, _, mesh_tag), rc, so, se in pool.map(run, cases):
            print(f"=== {arch} x {shape} x {mesh_tag}: {'ok' if rc == 0 else rc}", flush=True)
            print(so, flush=True)
            if rc != 0:
                failures.append((arch, shape, mesh_tag))
                print(se, flush=True)
    print(f"done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


def main(argv=None) -> int:
    args = _args(argv)
    out = pathlib.Path(args.out)
    if args.table:
        print(table(out))
        return 0
    out.mkdir(parents=True, exist_ok=True)

    if args.all:
        return _run_all(args, out)

    if not (args.arch and args.shape):
        print("--arch and --shape required (or --all)", file=sys.stderr)
        return 2
    # the fake process group first, before anything else builds a mesh
    from repro_torch.launch.mesh import fake_process_group, production_shape

    shape, _ = production_shape(args.multi_pod)
    n = 1
    for s in shape:
        n *= s
    fake_process_group(n)
    from repro_torch.launch.dryrun_lib import run_case

    overrides = json.loads(args.rules) if args.rules else None
    stats = run_case(args.arch, args.shape, multi_pod=args.multi_pod,
                     rule_overrides=overrides)
    mesh_tag = stats["mesh"]
    tag = f"__{args.tag}" if args.tag else ""
    fname = out / f"{args.arch}__{args.shape}__{mesh_tag}{tag}.json"
    fname.write_text(json.dumps(stats, indent=2))
    m = stats["memory"]
    from repro_torch import kernels

    launches = {name: getattr(kernels, name).launches for name in kernels.__all__}
    print(json.dumps(dict({k: stats[k] for k in
                           ("arch", "shape", "mesh", "trace_s", "flops_per_chip",
                            "bytes_per_chip", "collective_bytes_per_chip", "compute_s",
                            "memory_s", "collective_s", "dominant", "useful_flops_ratio")},
                          peak_bytes=m["peak_bytes"], fits_hbm=m["fits_hbm"],
                          kernel_launches=launches)))
    print(f"peak {m['peak_bytes'] / 1e9:.2f} GB/chip  fits={m['fits_hbm']}")
    print(f"wrote {fname}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
