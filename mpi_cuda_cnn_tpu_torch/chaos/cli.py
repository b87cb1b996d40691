"""`python -m mpi_cuda_cnn_tpu_torch chaos`: the seeded fault-schedule
search driver (counterpart of the reference's `chaos/cli.py`).

Default mode samples N (axes, plan) episodes, runs each through the
episode harness + global invariant oracle, and folds a deterministic
episode CRC chain (the number the CI chaos gate pins at 0%/equal
across two identical invocations). On any violation the run keeps
going (the chain must stay comparable), then shrinks the FIRST
violating episode to a minimal plan, writes both trails of the
minimal episode for `diverge`, prints the one-line repro, and
exits 1.

`--plan` mode replays exactly one episode from a plan spelling — the
repro form the failure path prints — with the axes set by flags
instead of sampled.

The episode streams' seed strings and the run markers keep the
reference's spelling ("mctpu-chaos:...", "# run ... mctpu chaos"), so
both packages draw the same episodes and write the same bytes; the
printed repro and diverge commands name this package.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import zlib
from pathlib import Path

from ..faults import parse_plan, validate_plan_sites
from ..obs.schema import RUN_MARKER, make_record, validate_record
from .episode import EpisodeConfig, EpisodeResult, config_for, run_episode
from .sampler import SURFACE, EpisodeAxes, sample_axes, sample_plan
from .shrink import shrink


def _episode_rng(seed: int, ep: int) -> random.Random:
    """One independent, platform-stable stream per episode: string
    seeding hashes the bytes (not PYTHONHASHSEED), so episode k of
    seed s samples identically everywhere, forever."""
    return random.Random(f"mctpu-chaos:{seed}:{ep}")


def _write_trail(path: Path, records: list[dict]) -> None:
    with path.open("w") as fh:
        fh.write(f"{RUN_MARKER} mctpu chaos\n")
        for rec in records:
            fh.write(json.dumps(rec) + "\n")


def _emit(path: str, rows: list[dict]) -> None:
    """Append schema-stamped chaos records (the autosize emit shape):
    one run segment per invocation, t = the episode ordinal — the
    chaos timeline is episode-indexed, never wall-clock."""
    with open(path, "a") as fh:
        fh.write(f"{RUN_MARKER} mctpu chaos\n")
        for i, row in enumerate(rows):
            rec = validate_record(make_record("chaos", float(i), **row))
            fh.write(json.dumps(rec) + "\n")


def _fail_report(args, ep: int, res: EpisodeResult) -> tuple[str, dict]:
    """Shrink the violating episode, write the minimal episode's twin
    trails, print the repro block. Returns (min_plan, extra summary
    fields)."""
    cfg = res.config
    checks = sorted({v["check"] for v in res.violations})
    for v in res.violations:
        print(f"  {v['check']}: {v['detail']}")
    min_plan, probes = cfg.plan, 0
    if cfg.plan and not args.no_shrink:
        min_plan, probes = shrink(cfg)
        print(f"shrunk: {len(parse_plan(cfg.plan))} fault(s) -> "
              f"{len(parse_plan(min_plan))} over {probes} probe "
              f"episode(s)")
    extra = {"failed_episode": ep, "min_plan": min_plan,
             "shrink_probes": probes}
    min_res = run_episode(EpisodeConfig(
        **{**cfg.__dict__, "plan": min_plan}))
    if args.out_dir:
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        a, b = out / "chaos_min_a.jsonl", out / "chaos_min_b.jsonl"
        _write_trail(a, min_res.records_a)
        _write_trail(b, min_res.records_b)
        print(f"trails: {a} {b}\n"
              f"diverge: python -m mpi_cuda_cnn_tpu_torch diverge {a} {b}")
    axes_flags = []
    if cfg.pools:
        axes_flags.append(f"--pools {cfg.pools}")
    if cfg.prefix:
        axes_flags.append("--prefix")
    if cfg.spill:
        axes_flags.append("--spill")
    if cfg.spec != "off":
        axes_flags.append(f"--spec {cfg.spec}")
    if cfg.autoscale:
        axes_flags.append("--autoscale")
    if cfg.transport:
        axes_flags.append("--transport")
    if cfg.plant:
        axes_flags.append(f"--plant {cfg.plant}")
    flags = (" " + " ".join(axes_flags)) if axes_flags else ""
    print(f"minimal plan ({', '.join(checks)}): {min_plan}\n"
          f"repro: python -m mpi_cuda_cnn_tpu_torch chaos --seed {cfg.seed}"
          f" --requests {cfg.requests} --replicas {cfg.replicas}{flags}"
          f" --plan '{min_plan}'")
    return min_plan, extra


def chaos_main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch chaos",
        description="Seeded fault-schedule search over the fleet storm "
                    "with a global invariant oracle and automatic ddmin "
                    "plan minimization.",
    )
    ap.add_argument("--episodes", type=int, default=20,
                    help="sampled (axes, plan) episodes to run")
    ap.add_argument("--seed", type=int, default=0,
                    help="master seed: episode k samples from the "
                         "independent stream (seed, k)")
    ap.add_argument("--requests", type=int, default=32,
                    help="workload size per episode (tier-1 scale)")
    ap.add_argument("--replicas", type=int, default=3,
                    help="initial replicas (unified episodes; pooled "
                         "episodes size from the sampled split)")
    ap.add_argument("--max-tick", type=int, default=96,
                    help="latest fleet.tick trigger the sampler draws")
    ap.add_argument("--plan", default=None,
                    help="replay ONE episode from this --fault-plan "
                         "spelling instead of sampling (the repro form "
                         "a failing search prints); axes come from the "
                         "flags below")
    ap.add_argument("--pools", default=None,
                    help="disaggregated split for --plan mode "
                         "(fleet-bench grammar: prefill:P,decode:D)")
    ap.add_argument("--prefix", action="store_true",
                    help="prefix cache on (--plan mode)")
    ap.add_argument("--spill", action="store_true",
                    help="host-tier spill on; needs --prefix "
                         "(--plan mode)")
    ap.add_argument("--spec", default="off", choices=("off", "lookup"),
                    help="speculative decoding (--plan mode)")
    ap.add_argument("--autoscale", action="store_true",
                    help="online autoscaler on (--plan mode)")
    ap.add_argument("--transport", action="store_true",
                    help="lossy transport bus + lease fences on; "
                         "required for fleet.transport plan entries "
                         "(--plan mode)")
    ap.add_argument("--no-shrink", action="store_true",
                    help="report the raw violating plan without ddmin "
                         "minimization")
    ap.add_argument("--out-dir", default=None,
                    help="directory for the minimal episode's twin "
                         "trails on failure (pre-wired for "
                         "`diverge`)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append one chaos record per episode plus the "
                         "run summary (obs schema; the CI chaos gate "
                         "compares these)")
    ap.add_argument("--plant", default=None,
                    choices=("skip-revoke", "skip-dedup"),
                    help="TEST-ONLY: arm a planted invariant bug "
                         "(serve/fleet.CHAOS_PLANT) the search must "
                         "find and shrink — skip-revoke drops a fence "
                         "revoke on failover, skip-dedup disables the "
                         "bus's commit dedup check; the "
                         "oracle's own canary, never for real runs")
    args = ap.parse_args(argv)
    if args.spill and not args.prefix:
        print("error: --spill needs --prefix (the host tier spills "
              "prefix-tree pages)", file=sys.stderr)
        return 2

    if args.plan is not None:
        try:
            validate_plan_sites(parse_plan(args.plan), SURFACE)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        axes = EpisodeAxes(pools=args.pools, prefix=args.prefix,
                           spill=args.spill, spec=args.spec,
                           autoscale=args.autoscale,
                           transport=args.transport)
        episodes = [(args.plan, axes)]
    else:
        episodes = []
        for ep in range(args.episodes):
            rng = _episode_rng(args.seed, ep)
            axes = sample_axes(rng)
            n_replicas = (sum(int(p.rsplit(":", 1)[1])
                              for p in axes.pools.split(","))
                          if axes.pools else args.replicas)
            episodes.append((sample_plan(rng, axes, replicas=n_replicas,
                                         max_tick=args.max_tick), axes))

    rows: list[dict] = []
    chain = 0
    first_fail: tuple[int, EpisodeResult] | None = None
    for ep, (plan, axes) in enumerate(episodes):
        # Sampled episodes decorrelate workloads per ordinal; --plan
        # mode replays the EXACT seed the failure report printed.
        ep_seed = (args.seed if args.plan is not None
                   else args.seed * 100003 + ep)
        cfg = config_for(ep_seed, plan, axes,
                         requests=args.requests, replicas=args.replicas,
                         plant=args.plant)
        res = run_episode(cfg)
        chain = zlib.crc32(res.crc.to_bytes(4, "little"), chain)
        rows.append({**res.row, "episode": ep, "axes": axes.label()})
        verdict = ("ok" if res.ok
                   else "FAIL " + ",".join(sorted({v["check"]
                                                   for v in res.violations})))
        print(f"episode {ep:3d} [{axes.label()}] {plan or '(no faults)'}"
              f" -> {verdict}")
        if not res.ok and first_fail is None:
            first_fail = (ep, res)
    failed = [r["episode"] for r in rows if r["violations"]]
    summary = {
        "kind": "summary", "episodes": len(rows),
        "violations": len(failed), "failed": failed,
        "episodes_crc": chain,
    }
    if first_fail is not None:
        _, extra = _fail_report(args, *first_fail)
        summary.update(extra)
    if args.metrics_jsonl:
        _emit(args.metrics_jsonl, rows + [summary])
    print(f"chaos: {len(rows)} episode(s), {len(failed)} violating, "
          f"episodes_crc {chain}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(chaos_main())
