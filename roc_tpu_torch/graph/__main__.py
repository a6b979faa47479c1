"""Convert standard dataset dumps to the ROC on-disk format (the port's
counterpart of tools/convert.py: the same arguments and the same files).

    python -m roc_tpu_torch.graph edgelist --edges g.txt [--feats f.csv]
        [--labels l.txt] [--mask m.txt] [--num-nodes N] [--undirected]
        [--split TR,VA,TE] [--seed S] -o out/prefix
    python -m roc_tpu_torch.graph ogb --dir ogbn_arxiv/raw -o out/prefix
    python -m roc_tpu_torch.graph mtx --file graph.mtx -o out/prefix
    python -m roc_tpu_torch.graph karate -o out/prefix   # vendored real
    python -m roc_tpu_torch.graph davis -o out/prefix    # graphs:
    python -m roc_tpu_torch.graph lesmis -o out/prefix   # data/*/README.md
    python -m roc_tpu_torch.graph rocfile --file in/prefix --in-dim D
        --classes C -o out/prefix

Every command also takes ``--reorder [on|off|auto]`` (the RCM pass before
writing) and ``--with-transpose`` (the ``.t.lux`` sidecar).  Output:
``<prefix>.add_self_edge.lux`` + ``.feats.csv``/``.feats.bin``/``.label``/
``.mask``, trainable via ``python -m roc_tpu_torch -file <prefix>``.
"""

import argparse
import os
import sys

from roc_tpu_torch.graph import convert, datasets, lux
from roc_tpu_torch.graph.reorder import maybe_reorder_dataset


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m roc_tpu_torch.graph",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("edgelist", help="plain 'src dst' edge-list dump")
    e.add_argument("--edges", required=True)
    e.add_argument("--num-nodes", type=int, default=None)
    e.add_argument("--feats", default=None, help="CSV, one row per node")
    e.add_argument("--labels", default=None, help="one int id per line")
    e.add_argument("--mask", default=None,
                   help=".mask (Train/Val/Test/None lines) or int file")
    e.add_argument("--undirected", action="store_true",
                   help="symmetrize + dedup edges")
    e.add_argument("--directed-as-is", dest="undirected",
                   action="store_false")
    e.add_argument("--no-self-edges", action="store_true")
    e.add_argument("--split", default=None,
                   help="TRAIN,VAL,TEST counts for a seeded stratified "
                        "split (when no --mask)")
    e.add_argument("--seed", type=int, default=0)

    o = sub.add_parser("ogb", help="extracted OGB-style raw/ directory")
    o.add_argument("--dir", required=True)
    o.add_argument("--directed", action="store_true",
                   help="keep edges directed (default symmetrizes)")
    o.add_argument("--seed", type=int, default=0)

    m = sub.add_parser("mtx", help="MatrixMarket coordinate file "
                                   "(SuiteSparse graph dumps)")
    m.add_argument("--file", required=True)
    m.add_argument("--labels", default=None)
    m.add_argument("--feats", default=None)
    m.add_argument("--undirected", action="store_true", default=None,
                   help="symmetrize a 'general'-header dump (symmetric "
                        "headers symmetrize automatically)")
    m.add_argument("--no-self-edges", action="store_true")
    m.add_argument("--split", default=None,
                   help="TRAIN,VAL,TEST counts for a seeded stratified "
                        "split")
    m.add_argument("--seed", type=int, default=0)

    sub.add_parser("karate",
                   help="vendored real graph: Zachary's karate club")
    sub.add_parser("davis", help="vendored real graph: Davis Southern "
                                 "Women (1941, bipartite)")
    sub.add_parser("lesmis", help="vendored real graph: Les Misérables "
                                  "co-occurrences (Knuth 1993)")

    r = sub.add_parser("rocfile", help="re-process an existing ROC-format "
                                      "dataset (e.g. to apply --reorder "
                                      "or add the transpose sidecar)")
    r.add_argument("--file", required=True, help="input path prefix")
    r.add_argument("--in-dim", type=int, required=True)
    r.add_argument("--classes", type=int, required=True)

    for s in sub.choices.values():
        s.add_argument("-o", "--out", required=True,
                       help="output path prefix")
        s.add_argument("--with-transpose", action="store_true",
                       help="also write the transposed-graph sidecar "
                            "(.t.lux) that -edge-shard -perhost loading "
                            "needs for its backward blocks")
        s.add_argument("--reorder", nargs="?", const="on", default="off",
                       choices=["on", "off", "auto"],
                       help="apply the RCM locality pass before writing "
                            "(graph/reorder.py; 'auto' keeps the order "
                            "only on a measured >=10%% cell-padding "
                            "reduction): preprocess once instead of "
                            "paying -reorder per run")

    a = p.parse_args(argv)
    if a.cmd == "edgelist":
        split = tuple(int(x) for x in a.split.split(",")) if a.split else None
        if split is not None and len(split) != 3:
            p.error("--split wants TRAIN,VAL,TEST (three counts)")
        ds = convert.from_edge_list(
            a.edges, num_nodes=a.num_nodes, feats_path=a.feats,
            labels_path=a.labels, mask_path=a.mask, undirected=a.undirected,
            self_edges=not a.no_self_edges, split=split, seed=a.seed)
    elif a.cmd == "ogb":
        ds = convert.from_ogb_dir(a.dir, undirected=not a.directed,
                                  seed=a.seed)
    elif a.cmd == "mtx":
        split = tuple(int(x) for x in a.split.split(",")) if a.split else None
        if split is not None and len(split) != 3:
            p.error("--split wants TRAIN,VAL,TEST (three counts)")
        ds = convert.from_mtx(a.file, labels_path=a.labels,
                              feats_path=a.feats, undirected=a.undirected,
                              self_edges=not a.no_self_edges, split=split,
                              seed=a.seed)
    elif a.cmd == "rocfile":
        ds = datasets.load_roc_dataset(a.file, a.in_dim, a.classes)
    elif a.cmd == "davis":
        ds = convert.davis_women()
    elif a.cmd == "lesmis":
        ds = convert.les_miserables()
    else:
        ds = convert.karate_club()
    if a.reorder != "off":
        ds, _, note = maybe_reorder_dataset(ds, a.reorder)
        print(f"# {note}", file=sys.stderr)
    convert.write(ds, a.out)
    # Refresh the transpose sidecar whenever one exists at the output
    # prefix, not only under --with-transpose: a rewrite (esp. --reorder)
    # would otherwise leave a stale .t.lux that PASSES the header check
    # of roc_tpu/graph/shard_load.py (node/edge counts are permutation-invariant) and
    # silently corrupts -edge-shard -perhost backward blocks.
    if a.with_transpose or os.path.exists(a.out + lux.TLUX_SUFFIX):
        lux.write_transpose(a.out, ds.graph)
        print(f"wrote {a.out}{lux.TLUX_SUFFIX} (transposed sidecar)",
              file=sys.stderr)
    print(f"wrote {a.out}.add_self_edge.lux + sidecars: "
          f"{ds.graph.num_nodes} nodes, {ds.graph.num_edges} edges "
          f"(self-edges incl.), in_dim={ds.in_dim}, "
          f"classes={ds.num_classes}", file=sys.stderr)
    print(f"train with:  python -m roc_tpu_torch -file {a.out} "
          f"-layers {ds.in_dim}-16-{ds.num_classes} -e 100", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
