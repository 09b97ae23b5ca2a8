"""Similarity-campaign launcher: the paper's workload as a CLI over the
port's ``repro_torch.api`` engine.

    python -m repro_torch.launch.similarity --way 2 --n-f 1000 --n-v 512 \\
        --metric czekanowski --impl pallas --out /tmp/metrics
    python -m repro_torch.launch.similarity --way 2 --dataset ds/

The port of ``repro.launch.similarity``: the same flags, defaults and
output lines (``metric=… way=…``, ``results=… time=… rate=…``,
``checksum=0x…``; ``streamed chunks=…`` for a streamed campaign
(``--streaming``, ``--max-host-bytes``) and ``delta n_old=…`` for a
border-block delta (``--delta-from``); for a batched campaign,
``--metrics`` / ``--subsets``, one ``campaign …`` line each and ``--out``
one directory each; with ``--trace OUT.json`` the Chrome trace file, the
phase table, the ``obs comparisons=…`` line and ``trace=… events=…``), plus
``--device {cuda,cpu}`` (default ``cuda``), the CLI's form of
``SimilarityEngine(device=)``; ``--devices N`` gives the engine N ranks
(``SimilarityEngine(devices=)``: N on the CPU, or the visible cards in
turn) for a 2-way or 3-way decomposition (``--n-pf`` / ``--n-pv`` /
``--n-pr``):

    python -m repro_torch.launch.similarity --device cpu --devices 4 \
        --way 3 --n-pv 4
"""
import argparse
import os
import sys

from repro_torch.launch import no_device


def _parse_metrics(metrics: str, metric: str) -> list:
    """'czekanowski,sorenson' -> campaign metric names (primary first);
    an empty --metrics falls back to the single --metric."""
    if not metrics:
        return [metric]
    names = [m.strip() for m in metrics.split(",") if m.strip()]
    if not names:
        raise ValueError("--metrics given but no metric names parsed")
    return names


def _parse_subsets(subsets: str) -> tuple:
    """';'-separated 'name=lo:hi[:step]' or 'name=i,j,k' -> request tuples."""
    if not subsets:
        return ()
    out = []
    for part in subsets.split(";"):
        part = part.strip()
        if not part:
            continue
        name, eq, spec = part.partition("=")
        if not eq or not name.strip() or not spec.strip():
            raise ValueError(
                f"--subsets entry {part!r} is not 'name=lo:hi[:step]' "
                f"or 'name=i,j,k'"
            )
        name, spec = name.strip(), spec.strip()
        try:
            if ":" in spec:
                fields = [int(x) for x in spec.split(":")]
                if len(fields) not in (2, 3):
                    raise ValueError
                idx = tuple(range(*fields))
            else:
                idx = tuple(int(x) for x in spec.split(","))
        except ValueError:
            raise ValueError(
                f"--subsets entry {part!r}: bad index spec {spec!r}"
            ) from None
        out.append((name, idx))
    return tuple(out)


def _report_batched(batched, request, args) -> int:
    """Per-campaign result rows + the shared accounting; ``--out`` saves
    each campaign to a directory of its own, ``metric[__subset]``."""
    b = batched.meta["batch"]
    print(f"batched campaigns={b['campaigns']} "
          f"metrics={','.join(request.campaign_metrics())} "
          f"subsets={','.join(b['subsets']) or '(full)'} "
          f"families={b['families']} way={b['way']}")
    print(f"ring payload_bytes_per_rank={b['payload_bytes_per_rank']} "
          f"ring_steps={b['ring_steps']} n_ranks={b['n_ranks']} "
          f"ring_payload_bytes={b['ring_payload_bytes']} "
          f"stat_ring_bytes={b['stat_ring_bytes']} "
          f"traversals={b['traversals']} encodes={b['encodes']}")
    for mname, sname, result in batched:
        n_results = result.num_results()
        print(f"campaign metric={mname} subset={sname or '(full)'} "
              f"n_v={result.n_v} results={n_results} "
              f"checksum={hex(result.checksum())}")
        if args.out:
            sub = mname + (f"__{sname}" if sname else "")
            result.save(os.path.join(args.out, sub))
    print(f"time={batched.seconds:.3f}s")
    return 0


def _report_trace(tracer, result, args) -> None:
    """--trace epilogue: write the Chrome trace file, print the per-phase
    table (every canonical phase, count 0 when it never ran) and the
    roofline-utilization line from ``meta["obs"]``."""
    if tracer is None:
        return
    from repro_torch.obs import trace as obs_trace

    obs_trace.disable()
    tracer.write_chrome_trace(args.trace)
    print(obs_trace.format_phase_table(tracer.phase_stats()))
    ob = result.meta.get("obs") or {}
    line = (f"obs comparisons={ob.get('comparisons')} "
            f"rate={ob.get('comparisons_per_s', 0.0):.3e} comparisons/s")
    if "bound_seconds" in ob:
        line += (f" bound_seconds={ob['bound_seconds']:.6f}"
                 f" bottleneck={ob.get('bottleneck')}")
    if "utilization" in ob:
        line += f" utilization={ob['utilization']:.3e}"
    print(line)
    print(f"trace={args.trace} events={tracer.event_count()}")


def _ranks(args) -> list:
    """The engine's ranks for ``--devices N``: N ranks on the CPU, or the
    visible cards in turn (N ranks on one card take it N times); None for
    0, the engine's own default."""
    if not args.devices:
        return None
    if args.device == "cpu":
        return ["cpu"] * args.devices
    import torch

    n = torch.cuda.device_count()
    return [f"cuda:{i % n}" for i in range(args.devices)]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.similarity")
    ap.add_argument("--metric", default="czekanowski",
                    help="registered metric name (see --list-metrics)")
    ap.add_argument("--metrics", default="",
                    help="comma-separated metric list for a batched campaign "
                         "over one payload (overrides --metric; the first "
                         "name is the primary)")
    ap.add_argument("--subsets", default="",
                    help="named vector-index subsets for a batched campaign, "
                         "';'-separated 'name=SPEC' with SPEC either "
                         "'lo:hi[:step]' or 'i,j,k'; each subset runs as its "
                         "own campaign over the shared payload (no re-encode)")
    ap.add_argument("--list-metrics", action="store_true",
                    help="print every registered metric (sorted) with its "
                         "one-line description and exit")
    ap.add_argument("--way", type=int, default=2, choices=(2, 3))
    ap.add_argument("--n-f", type=int, default=512)
    ap.add_argument("--n-v", type=int, default=240)
    ap.add_argument("--n-pf", type=int, default=1)
    ap.add_argument("--n-pv", type=int, default=1)
    ap.add_argument("--n-pr", type=int, default=1)
    ap.add_argument("--n-st", type=int, default=1)
    ap.add_argument("--stage", type=int, default=0,
                    help="3-way stage to run; -1 runs all n_st stages")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of the engine, which a decomposition "
                         "(--n-pf x --n-pv x --n-pr) must not exceed: with "
                         "--device cpu, N ranks on the CPU; on the card, "
                         "the visible cards in turn, so N ranks share one "
                         "card on a single-GPU host (0: the visible cards, "
                         "or the CPU alone)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the campaign runs: the card, or the CPU's "
                         "plain PyTorch versions")
    ap.add_argument("--impl", default=None,
                    help="mgemm implementation (default: xla, or levels "
                         "when --dataset is given)")
    ap.add_argument("--levels", type=int, default=None,
                    help="level count for impl='levels*' (default: 2, or "
                         "the dataset's encoded levels with --dataset)")
    ap.add_argument("--out-dtype", default="float32",
                    help="metric output dtype (e.g. float32, bfloat16, float16)")
    ap.add_argument("--ring-dtype", default="auto",
                    help="payload dtype; 'auto' picks int8 for small-integer "
                         "data, 'float32' opts out")
    ap.add_argument("--encoding", default="auto",
                    choices=("auto", "bitplane", "none"),
                    help="bit-plane pre-encoding for the levels path")
    ap.add_argument("--streaming", default="auto",
                    choices=("auto", "on", "off"),
                    help="out-of-core streaming over a --dataset: 'auto' "
                         "streams multi-shard (or --max-host-bytes budgeted) "
                         "datasets chunk by chunk through pinned staging "
                         "buffers, 'on' requires a dataset, 'off' always "
                         "materializes in memory; results are bit-identical "
                         "either way")
    ap.add_argument("--max-host-bytes", type=int, default=0,
                    help="staging-buffer budget in bytes for the streamed "
                         "pipeline (0 = one disk shard per chunk)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the resolved execution path (streamed-* "
                         "when the campaign streams), encoding, ring dtype "
                         "and the streaming decision, then exit without "
                         "running the campaign")
    ap.add_argument("--chunk", type=int, default=128,
                    help="impl='xla' min-plus contraction-chunk size")
    ap.add_argument("--input", default="", help=".npy (n_f, n_v) input")
    ap.add_argument("--dataset", default="",
                    help="packed bit-plane dataset directory "
                         "(repro_torch.store): the campaign loads "
                         "pre-encoded planes and never runs the host encoder")
    ap.add_argument("--max-value", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--append", default="",
                    help=".npy (n_f, m) matrix appended to --dataset before "
                         "the campaign (byte-column append); grows the "
                         "dataset in place")
    ap.add_argument("--delta-from", default="",
                    help="saved prior result directory covering the "
                         "dataset's first vectors: run a border-block delta "
                         "campaign (only the new-vs-all rectangle and the "
                         "new-vs-new triangle are computed and merged, "
                         "checksum bit-identical to a full recompute)")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="record per-phase spans (repro_torch.obs) during the "
                         "campaign, write Chrome/Perfetto trace-event JSON "
                         "to OUT.json, and print the phase table plus "
                         "roofline utilization after the run; checksums are "
                         "unchanged (tracing only adds timing fences)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from repro_torch.api import (
        InputSpec,
        SimilarityEngine,
        SimilarityRequest,
        UnknownMetricError,
        available_metrics,
    )

    if args.list_metrics:
        from repro_torch.api import get_metric

        for name in sorted(available_metrics()):
            desc = get_metric(name).description.split("\n")[0].strip()
            print(f"{name:16s} {desc}" if desc else name)
        return 0

    try:
        names = _parse_metrics(args.metrics, args.metric)
        subsets = _parse_subsets(args.subsets)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.dataset and args.input:
        print("error: --input and --dataset are mutually exclusive",
              file=sys.stderr)
        return 2
    if (args.append or not args.dry_run) and no_device(args.device):
        return 2
    if args.append:
        if not args.dataset:
            print("error: --append grows a --dataset store", file=sys.stderr)
            return 2
        import numpy as np

        from repro_torch.core.validate import validate_matrix
        from repro_torch.store import append_dataset

        try:
            V_new = validate_matrix(np.load(args.append), what=args.append,
                                    check_fp32_sums=True)
            manifest = append_dataset(args.dataset, V_new, device=args.device)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"appended {V_new.shape[1]} vector(s): {args.dataset} now "
              f"n_v={manifest['n_v']} (v{manifest['dataset_version']})")
    impl = args.impl or ("levels" if args.dataset else "xla")
    levels = args.levels
    if args.dataset:
        # pre-encoded campaign: the store's planes feed the engine directly
        from repro_torch.store import read_manifest

        try:
            manifest = read_manifest(args.dataset)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if levels is None:
            levels = manifest["levels"]
        input_spec = InputSpec(source="planes", path=args.dataset)
    elif args.input:
        input_spec = InputSpec(source="npy", path=args.input)
    else:
        input_spec = InputSpec(
            source="synthetic", n_f=args.n_f, n_v=args.n_v,
            max_value=args.max_value, seed=args.seed,
        )
    if levels is None:
        levels = 2
    stages = None if (args.way == 3 and args.stage < 0) else (
        (args.stage,) if args.way == 3 else None
    )
    request = SimilarityRequest(
        metric=names[0], metrics=tuple(names[1:]), subsets=subsets,
        way=args.way,
        n_pf=args.n_pf, n_pv=args.n_pv, n_pr=args.n_pr, n_st=args.n_st,
        stages=stages, impl=impl, levels=levels,
        out_dtype=args.out_dtype, ring_dtype=args.ring_dtype,
        encoding=args.encoding, chunk=args.chunk,
        streaming=args.streaming, max_host_bytes=args.max_host_bytes,
        input=input_spec, delta_from=args.delta_from,
    )

    if args.dry_run:
        # the executor's chosen path, so a declined fused path is visible
        import torch

        from repro_torch.api.engine import campaign_input
        from repro_torch.api.registry import batch_lead, get_metric
        from repro_torch.core.tile_executor import TileExecutor
        from repro_torch.core.twoway import resolve_config

        try:
            spec = get_metric(request.metric)
            request.validate(metric_spec=spec)
            specs = [get_metric(n) for n in request.campaign_metrics()]
            probe = campaign_input(request, spec, device=args.device)
            # a batch resolves its shared payload against the lead metric
            cfg = resolve_config(request.to_comet_config(), probe,
                                 batch_lead(specs) if request.is_batched else spec)
        except (UnknownMetricError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        # one row per campaign: each metric's path over the shared payload
        for mspec in specs:
            ex = TileExecutor(cfg=cfg, metric=mspec,
                              out_dtype=getattr(torch, args.out_dtype),
                              deferred=(cfg.streaming == "on"))
            path, why = ((ex.path, ex.path_reason) if args.way == 2
                         else (ex.path3, ex.path3_reason))
            reason = f" ({why})" if why else ""
            for sname, _ in request.campaign_subsets():
                row = f"path={path}{reason}"
                if request.is_batched:
                    row = (f"campaign metric={mspec.name} "
                           f"subset={sname or '(full)'} " + row)
                print(row)
        print(f"encoding={cfg.encoding} ring_dtype={cfg.ring_dtype} "
              f"impl={cfg.impl} levels={cfg.levels}")
        print(f"streaming={cfg.streaming} "
              f"max_host_bytes={cfg.max_host_bytes}")
        return 0

    tracer = None
    if args.trace:
        from repro_torch.obs import trace as obs_trace

        tracer = obs_trace.enable()
    try:
        result = SimilarityEngine(device=args.device,
                                  devices=_ranks(args)).run(request)
    except (UnknownMetricError, ValueError) as e:
        if tracer is not None:
            obs_trace.disable()
        print(f"error: {e}", file=sys.stderr)
        return 2

    if request.is_batched:
        rc = _report_batched(result, request, args)
        _report_trace(tracer, result, args)
        return rc

    n_results = result.num_results()
    comparisons = n_results * result.n_f
    checksum = result.checksum()
    print(f"metric={result.metric} way={result.way} "
          f"n_f={result.n_f} n_v={result.n_v} "
          f"decomp=({args.n_pf},{args.n_pv},{args.n_pr}) "
          f"stages={list(result.stages)}")
    print(f"results={n_results} time={result.seconds:.3f}s "
          f"rate={comparisons / max(result.seconds, 1e-12):.3e} comparisons/s")
    stream = result.meta.get("stream")
    if stream:
        print(f"streamed chunks={stream['chunks']} "
              f"chunk_bytes={stream['chunk_bytes']} "
              f"peak_host_bytes={stream['peak_host_bytes']} "
              f"n_shards={stream['n_shards']}")
    delta = result.meta.get("delta")
    if delta:
        print(f"delta n_old={delta['n_old']} n_new={delta['n_new']} "
              f"border_entries={delta['border_entries']} "
              f"computed_entries={delta['computed_entries']} "
              f"full_entries={delta['full_entries']} "
              f"ring_payload_bytes={delta['ring_payload_bytes']} "
              f"streamed={delta['streamed']}")
    print(f"checksum={hex(checksum)}")
    _report_trace(tracer, result, args)
    if args.out:
        result.save(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
