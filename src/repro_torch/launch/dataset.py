"""Dataset-store CLI: encode / append / inspect / validate plane datasets.

The port of ``repro.launch.dataset``: the same subcommands, flags, defaults
and printed lines, and the same dataset bytes.  ``encode`` decodes a PLINK
fileset and packs the planes, ``append`` packs the new planes and
``validate`` recounts the stats on ``--device`` (default ``cuda``; ``cpu``
runs the same code on the CPU).

    # encode: npy matrix, synthetic draw, or PLINK fileset -> dataset dir
    python -m repro_torch.launch.dataset encode --input V.npy --levels 2 --out ds/
    python -m repro_torch.launch.dataset encode --synthetic --n-f 1000 \\
        --n-v 512 --max-value 2 --seed 0 --out ds/ --shards 4
    python -m repro_torch.launch.dataset encode --bed cohort --missing drop --out ds/

    # append: grow a dataset with new vectors (the existing payload is
    # never re-encoded); omit --out to grow in place
    python -m repro_torch.launch.dataset append --to ds/ --input new.npy --out ds2/

    # inspect: manifest + stats summary; validate: recompute checksum + stats
    python -m repro_torch.launch.dataset inspect ds/
    python -m repro_torch.launch.dataset validate ds/

A campaign then reads the planes with no host encode:

    python -m repro_torch.launch.similarity --way 2 --dataset ds/
"""
import argparse
import sys

from repro_torch.launch import no_device


def _cmd_encode(args) -> int:
    import numpy as np

    from repro_torch.store import write_dataset

    picked = [bool(args.input), bool(args.bed), args.synthetic]
    if sum(picked) != 1:
        print("error: pick exactly one of --input / --bed / --synthetic",
              file=sys.stderr)
        return 2
    if no_device(args.device):
        return 2
    levels = args.levels
    if args.input:
        from repro_torch.core.validate import validate_matrix

        V = validate_matrix(np.load(args.input), what=args.input,
                            check_fp32_sums=True)
        source = {"kind": "npy", "path": args.input}
    elif args.bed:
        from repro_torch.store import read_bed

        V, source = read_bed(args.bed, missing=args.missing, device=args.device)
        if levels is None:
            levels = 2  # {0, 1, 2} dosages
    else:
        from repro_torch.core.synthetic import random_integer_vectors

        V = random_integer_vectors(
            args.n_f, args.n_v, max_value=args.max_value, seed=args.seed
        )
        source = {"kind": "synthetic", "n_f": args.n_f, "n_v": args.n_v,
                  "max_value": args.max_value, "seed": args.seed}
        if levels is None:
            levels = args.max_value
    if levels is None:
        levels = int(V.max()) if V.size else 1
    manifest = write_dataset(
        args.out, V, levels=levels, n_shards=args.shards, source=source,
        device=args.device,
    )
    print(f"wrote {args.out}: n_f={manifest['n_f']} n_v={manifest['n_v']} "
          f"levels={manifest['levels']} shards={manifest['n_shards']} "
          f"kb={manifest['kb']}")
    print(f"checksum={manifest['checksum']}")
    return 0


def _cmd_append(args) -> int:
    import numpy as np

    from repro_torch.store import append_dataset, read_manifest

    if bool(args.input) == args.synthetic:
        print("error: pick exactly one of --input / --synthetic",
              file=sys.stderr)
        return 2
    if no_device(args.device):
        return 2
    if args.input:
        from repro_torch.core.validate import validate_matrix

        V_new = validate_matrix(np.load(args.input), what=args.input,
                                check_fp32_sums=True)
    else:
        from repro_torch.core.synthetic import random_integer_vectors

        parent = read_manifest(args.to)
        # synthetic appends take the target's field count and draw within
        # its encoded level range, so the grown payload stays valid
        V_new = random_integer_vectors(
            parent["n_f"], args.n_v,
            max_value=(args.max_value if args.max_value is not None
                       else parent["levels"]),
            seed=args.seed,
        )
    manifest = append_dataset(args.to, V_new, out=(args.out or None),
                              device=args.device)
    where = args.out or args.to
    parent = manifest["parent"]
    print(f"appended {V_new.shape[1]} vector(s): {where} now n_v="
          f"{manifest['n_v']} (v{manifest['dataset_version']}, parent n_v="
          f"{parent['n_v']})")
    print(f"checksum={manifest['checksum']}")
    print(f"parent_checksum={parent['checksum']}")
    return 0


def _cmd_inspect(args) -> int:
    from repro_torch.kernels.mgemm_levels import planes_nbytes
    from repro_torch.store import DatasetReader

    r = DatasetReader(args.path)
    m = r.manifest
    stats = r.stats()
    print(f"dataset {args.path}")
    print(f"  n_f={m['n_f']} n_v={m['n_v']} levels={m['levels']} "
          f"kb={m['kb']} shards={m['n_shards']}")
    print(f"  payload={planes_nbytes(8 * m['kb'], m['n_v'], m['levels'])} bytes "
          f"({m['levels']} plane(s) x {m['kb']} bytes x {m['n_v']} vectors)")
    print(f"  checksum={m['checksum']}")
    print(f"  source={m.get('source', {})}")
    pops = stats.sum(axis=1)
    for t in range(m["levels"]):
        print(f"  plane {t + 1}: popcount={int(pops[t])}")
    print(f"  column-sum range=[{int(stats.sum(axis=0).min())}, "
          f"{int(stats.sum(axis=0).max())}]")
    return 0


def _cmd_validate(args) -> int:
    from repro_torch.store import DatasetReader

    if no_device(args.device):
        return 2
    m = DatasetReader(args.path).validate(device=args.device)
    print(f"{args.path}: OK ({m['n_shards']} shard(s), {m['checksum']})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dataset")
    sub = ap.add_subparsers(dest="cmd", required=True)

    enc = sub.add_parser("encode", help="encode a source into a plane dataset")
    enc.add_argument("--input", default="", help=".npy (n_f, n_v) matrix")
    enc.add_argument("--bed", default="",
                     help="PLINK fileset prefix (or .bed path)")
    enc.add_argument("--missing", default="error",
                     choices=("error", "zero", "drop"),
                     help="PLINK missing-genotype policy")
    enc.add_argument("--synthetic", action="store_true",
                     help="draw the paper's random-integer dataset")
    enc.add_argument("--n-f", type=int, default=512)
    enc.add_argument("--n-v", type=int, default=240)
    enc.add_argument("--max-value", type=int, default=2)
    enc.add_argument("--seed", type=int, default=0)
    enc.add_argument("--levels", type=int, default=None,
                     help="plane count (default: max-value for synthetic, "
                          "2 for bed, data max for npy)")
    enc.add_argument("--shards", type=int, default=1,
                     help="field shards on disk (= the n_pf byte ranges)")
    enc.add_argument("--out", required=True, help="dataset directory")
    enc.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="where the planes are packed")
    enc.set_defaults(fn=_cmd_encode)

    app = sub.add_parser("append",
                         help="append vectors to a dataset (byte-column "
                              "append; no re-encode of the existing payload)")
    app.add_argument("--to", required=True, help="existing dataset directory")
    app.add_argument("--input", default="",
                     help=".npy (n_f, m) matrix of new vectors")
    app.add_argument("--synthetic", action="store_true",
                     help="draw new synthetic vectors matching the "
                          "dataset's n_f and levels")
    app.add_argument("--n-v", type=int, default=32,
                     help="synthetic vector count to append")
    app.add_argument("--max-value", type=int, default=None,
                     help="synthetic value range (default: dataset levels)")
    app.add_argument("--seed", type=int, default=1)
    app.add_argument("--out", default="",
                     help="write the grown dataset here (default: grow "
                          "--to in place)")
    app.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="where the new planes are packed")
    app.set_defaults(fn=_cmd_append)

    ins = sub.add_parser("inspect", help="print manifest + stats summary")
    ins.add_argument("path")
    ins.set_defaults(fn=_cmd_inspect)

    val = sub.add_parser("validate",
                         help="recompute checksum + stats vs the manifest")
    val.add_argument("path")
    val.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="where the stats are recounted")
    val.set_defaults(fn=_cmd_validate)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
