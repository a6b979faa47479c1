"""Run configuration and CLI (roc_tpu/train/config.py), holding the fields
the ported serving, training, graph-input, run-control, memory-planner,
streaming, sharding and autotuning paths read.
Defaults, flag names, dests, environment mirrors and refusals match the
JAX package's (config.py:264-392, 398-508): a bad value exits with
SystemExit.  ``-device`` is the port's own.  ``-analyze`` parses, and the
CLI refuses it with its reason (``roc_tpu_torch/__main__.py``).

The environment mirrors of driverless entry points are roc_tpu's:
``ROC_MEGAFUSE``, ``ROC_FUSION_DEPTH`` and ``ROC_AUTOTUNE`` set their
fields here (config.py:295-309), ``ROC_NO_TUNED``, ``ROC_TUNED_PATH``,
``ROC_PLAN_CACHE`` and ``ROC_PLAN_CACHE_DIR`` place or turn off the tuned
store (``tune/store.py``), and the kill switches ``ROC_NO_MEGAFUSE``,
``ROC_MEGA_BWD=0``, ``ROC_XLAYER=0``, ``ROC_NO_GATFUSE`` and
``ROC_GAT_BWD=0`` are read at dispatch (``ops/switches.py``).  Some of
roc_tpu's have no meaning here: ``ROC_BINNED_*`` steer the binned plans'
geometry, Pallas lowering and VMEM gates, and the port's CSR kernels have
no plan; ``ROC_PLAN_CACHE_MIN_EDGES`` sizes the plan cache the port does
not keep (a CSR is built in seconds).  ``ROC_TPU_NO_NATIVE=1`` is read
where the graph is built: it selects the NumPy paths of the host graph
builders (``roc_tpu_torch/native``), which otherwise run in C++."""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

BACKENDS = ("auto", "xla", "matmul", "pallas", "binned")

_SIZE_SUFFIX = {"k": 2 ** 10, "m": 2 ** 20, "g": 2 ** 30, "t": 2 ** 40}


def parse_size(s: str) -> int:
    """A byte size with binary suffixes: '6g', '512m', '8589934592'; ""
    is 0 (no budget).  SystemExit on a malformed size (config.py:31-46)."""
    s = (s or "").strip().lower()
    if not s:
        return 0
    mult = 1
    if s[-1] in _SIZE_SUFFIX:
        mult = _SIZE_SUFFIX[s[-1]]
        s = s[:-1]
    try:
        return int(float(s) * mult)
    except ValueError:
        raise SystemExit(f"bad byte-size spec {s!r} "
                         "(want e.g. 6g, 512m, 8589934592)")


@dataclasses.dataclass
class Config:
    filename: str = ""            # ROC-format dataset prefix (-file)
    dataset: str = ""             # registry name (synthetic or vendored)
    layers: List[int] = dataclasses.field(default_factory=list)
    num_epochs: int = 1
    learning_rate: float = 0.01
    weight_decay: float = 0.05
    dropout_rate: float = 0.5
    decay_rate: float = 1.0
    decay_steps: int = 100
    model: str = "gcn"            # gcn | gcn-chain | sage | gin | gat
    heads: int = 8                # attention heads (gat only)
    aggr: str = ""                # "" = the model's default
    seed: int = 1
    num_parts: int = 1            # parts: > 1 trains them through the
                                  # SPMD trainer (parallel/), or with
                                  # -stream through the streaming executor
    aggregate_backend: str = "auto"  # auto | xla | matmul | pallas | binned
    aggregate_precision: str = "fast"  # fast: one bf16 rounding of features
                                  # at aggregation input, fp32 accumulation;
                                  # exact: fp32 end to end
    verbose: bool = False
    eval_every: int = 5           # the reference evaluates every 5 epochs
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0     # 0 = disabled
    resume: bool = False
    megafuse: bool = False        # whole-layer megakernel: each eligible
                                  # aggregate->linear(->relu) layer runs as
                                  # one kernel forward and one backward
    fusion_depth: int = 1         # cross-layer fusion-region cap (needs
                                  # megafuse): 1 off, N chains of at most
                                  # N layers, 0 unlimited
    autotune: bool = False        # sweep this graph's kernel launch
                                  # configurations (tune/) before the CSR
                                  # is placed and keep the winners in the
                                  # tuned store, which the placement reads
                                  # (ROC_NO_TUNED=1: not read)
    analyze: bool = False         # roc_tpu's audit of its lowered XLA
                                  # steps; the CLI refuses it
    lazy_load: bool = False       # memmap features / defer one-hot labels
    reorder: str = "off"          # RCM vertex order before training:
                                  # off | on | auto (kept on a >=10% cut
                                  # of graph/reorder.py:padded_rows)
    device: str = "cuda"          # cuda, or cpu when asked for
    serve_batch: int = 64         # microbatch cap and top of the bucket ladder
    serve_wait_ms: float = 2.0    # max ms a serving window stays open
    serve_queue_max: int = 4096   # pending requests before submit() sheds;
                                  # 0 = unbounded
    use_bf16: bool = False        # x and the activations up to the first
                                  # promotion in bf16 (-bf16)
    bf16_storage: bool = False    # bf16 feature storage, fp32 accumulation
                                  # (-bf16-storage): on one device in fast
                                  # the sums already stage bf16, so it
                                  # changes no bit there; under -parts the
                                  # exchanges move bf16 (parallel/wire.py)
    bf16_rounding: str = "nearest"  # the wire's rounding: nearest |
                                  # stochastic (straight-through gradient)
    bf16_exchange: str = "plain"  # plain | compensated: a (hi, lo) bf16
                                  # pair, fp32's bytes again
    halo: bool = True             # halo exchange vs allgather (-no-halo)
    exchange: str = ""            # halo | allgather | ring ("" derives it
                                  # from halo)
    halo_overlap: bool = True     # split each part's edges into local- and
                                  # remote-source CSRs (k = 1, halo,
                                  # kernel backend, sum/avg); off:
                                  # -no-halo-overlap
    check_sharding: bool = False  # the CLI checks sharded == one device
                                  # before training (parallel/check.py)
    multihost: bool = False       # one process per device on
                                  # torch.distributed (torchrun's env)
    perhost_load: bool = False    # build the parts from the .lux byte
                                  # ranges (graph/shard_load.py); -file,
                                  # k = 1
    edge_shard: object = "auto"   # on | off | auto: exactly-equal edge
                                  # blocks; auto turns them on where
                                  # roc_tpu would (padded-max tax > 30%)
    balance_every: int = 0        # online balancer cadence in epochs
                                  # (balance/); 0 = off.  SPMD vertex modes
                                  # at k = 1; elsewhere ignored with a note
    balance_min_gain: float = 0.05  # reshard only when the predicted
                                  # max-part time drops by this fraction
    balance_trace: str = ""       # the balancer's JSONL trace ("" = none)
    fault: str = ""               # fault-injection spec (fault/inject.py),
                                  # e.g. "seed=3,step.nan=1"; "" = disarmed
    profile_dir: str = ""         # torch.profiler trace directory
    profile_epochs: str = ""      # profiler window "START:COUNT" from the
                                  # call's first epoch ("" = "3:3")
    obs: bool = False             # spans, per-epoch metrics and the
                                  # watchdog, exported under obs_dir
    obs_dir: str = ""             # "" with obs on -> "roc_obs"
    mem_plan: str = "keep"        # activation-memory plan (memory/): keep
                                  # (no checkpointing) | auto (the DP under
                                  # -mem-budget) | remat (every layer)
    mem_budget: str = ""          # per-device budget for -mem-plan auto
                                  # (k/m/g/t suffixes; "" = the card's
                                  # memory, unbounded on the CPU)
    stream: bool = False          # out-of-core streaming executor
                                  # (stream/): shards in host memory rotate
                                  # through -stream-slots device slots;
                                  # needs -parts >= 2
    stream_slots: int = 2         # prefetch ring depth (2 = double
                                  # buffering)
    stream_budget: str = ""       # device budget the in-core path is held
                                  # to: a graph whose placed data exceeds
                                  # it refuses to run without -stream
    stream_spill: str = ""        # directory for the boundary-activation
                                  # and cotangent stores (CRC'd memmaps)
                                  # instead of host memory; needs -stream

    def __post_init__(self):
        env = os.environ
        try:
            if "ROC_BALANCE_EVERY" in env:
                self.balance_every = int(env["ROC_BALANCE_EVERY"])
            if "ROC_BALANCE_MIN_GAIN" in env:
                self.balance_min_gain = float(env["ROC_BALANCE_MIN_GAIN"])
        except ValueError:
            raise SystemExit("ROC_BALANCE_EVERY / ROC_BALANCE_MIN_GAIN "
                             "must be numeric")
        if env.get("ROC_BALANCE_TRACE"):
            self.balance_trace = env["ROC_BALANCE_TRACE"]
        if self.aggregate_backend not in BACKENDS:
            raise SystemExit(f"aggregate_backend={self.aggregate_backend!r}:"
                             f" one of {'|'.join(BACKENDS)}")
        if self.aggregate_precision not in ("fast", "exact"):
            raise SystemExit(f"aggregate_precision="
                             f"{self.aggregate_precision!r}: fast|exact")
        if self.eval_every < 1 or self.decay_steps < 1:
            raise SystemExit(f"eval_every={self.eval_every} and decay_steps="
                             f"{self.decay_steps} must be >= 1")
        if env.get("ROC_BF16_STORAGE"):
            self.bf16_storage = env["ROC_BF16_STORAGE"] == "1"
        if env.get("ROC_BF16_ROUNDING"):
            self.bf16_rounding = env["ROC_BF16_ROUNDING"]
        if env.get("ROC_BF16_EXCHANGE"):
            self.bf16_exchange = env["ROC_BF16_EXCHANGE"]
        if self.bf16_rounding not in ("nearest", "stochastic"):
            raise SystemExit(f"bad bf16_rounding {self.bf16_rounding!r} "
                             "(nearest|stochastic)")
        if self.bf16_exchange not in ("plain", "compensated"):
            raise SystemExit(f"bad bf16_exchange {self.bf16_exchange!r} "
                             "(plain|compensated)")
        # ROC_MEGAFUSE, ROC_FUSION_DEPTH and ROC_AUTOTUNE mirror their
        # flags for driverless entry points (config.py:295-309); the kill
        # switches stay runtime checks at dispatch (ops/switches.py)
        if env.get("ROC_MEGAFUSE"):
            self.megafuse = env["ROC_MEGAFUSE"] == "1"
        if env.get("ROC_FUSION_DEPTH"):
            self.fusion_depth = int(env["ROC_FUSION_DEPTH"])
        if self.fusion_depth < 0:
            raise SystemExit(f"bad fusion_depth {self.fusion_depth} "
                             "(0 = full, 1 = off, >=2 = cap)")
        if env.get("ROC_AUTOTUNE"):
            self.autotune = env["ROC_AUTOTUNE"] == "1"
        if self.bf16_storage and self.aggregate_precision == "exact":
            raise SystemExit("-bf16-storage is incompatible with "
                             "-aggr-precision exact (bf16 storage rounds "
                             "features; exact promises fp32 end to end)")
        if env.get("ROC_OBS"):
            self.obs = env["ROC_OBS"] == "1"
        if env.get("ROC_OBS_DIR"):
            self.obs_dir = env["ROC_OBS_DIR"]
        if self.obs and not self.obs_dir:
            self.obs_dir = "roc_obs"
        if env.get("ROC_PROFILE_EPOCHS"):
            self.profile_epochs = env["ROC_PROFILE_EPOCHS"]
        self.profile_window()  # validate eagerly (SystemExit if bad)
        try:
            if "ROC_SERVE_BATCH" in env:
                self.serve_batch = int(env["ROC_SERVE_BATCH"])
            if "ROC_SERVE_WAIT_MS" in env:
                self.serve_wait_ms = float(env["ROC_SERVE_WAIT_MS"])
        except ValueError:
            raise SystemExit("ROC_SERVE_BATCH must be an integer and "
                             "ROC_SERVE_WAIT_MS numeric")
        if self.serve_batch < 1:
            raise SystemExit(f"serve_batch={self.serve_batch}: the serving "
                             "window must admit at least one query")
        if self.serve_wait_ms < 0:
            raise SystemExit(f"serve_wait_ms={self.serve_wait_ms} must be "
                             ">= 0 (0 drains after every request)")
        try:
            if "ROC_SERVE_QUEUE_MAX" in env:
                self.serve_queue_max = int(env["ROC_SERVE_QUEUE_MAX"])
        except ValueError:
            raise SystemExit("ROC_SERVE_QUEUE_MAX must be an integer")
        if self.serve_queue_max < 0:
            raise SystemExit(f"serve_queue_max={self.serve_queue_max} must "
                             "be >= 0 (0 disables the depth cap)")
        if env.get("ROC_MEM_PLAN"):
            self.mem_plan = env["ROC_MEM_PLAN"]
        if self.mem_plan not in ("keep", "auto", "remat"):
            raise SystemExit(f"bad mem_plan {self.mem_plan!r} "
                             "(keep|auto|remat)")
        if env.get("ROC_MEM_BUDGET"):
            self.mem_budget = env["ROC_MEM_BUDGET"]
        parse_size(self.mem_budget)  # validate eagerly (SystemExit if bad)
        if env.get("ROC_STREAM"):
            self.stream = env["ROC_STREAM"] == "1"
        try:
            if "ROC_STREAM_SLOTS" in env:
                self.stream_slots = int(env["ROC_STREAM_SLOTS"])
        except ValueError:
            raise SystemExit("ROC_STREAM_SLOTS must be an integer")
        if env.get("ROC_STREAM_BUDGET"):
            self.stream_budget = env["ROC_STREAM_BUDGET"]
        parse_size(self.stream_budget)
        if env.get("ROC_STREAM_SPILL"):
            self.stream_spill = env["ROC_STREAM_SPILL"]
        if self.stream_slots < 2:
            raise SystemExit(f"stream_slots={self.stream_slots}: the "
                             "prefetch ring needs >= 2 slots (double "
                             "buffering is the point)")
        if self.stream_spill and not self.stream:
            raise SystemExit("error: -stream-spill is a tier of the "
                             "streaming executor; it requires -stream")
        if env.get("ROC_FAULT"):
            self.fault = env["ROC_FAULT"]
        if self.fault:
            from roc_tpu_torch.fault import inject
            try:
                inject.parse_spec(self.fault)
            except ValueError as e:
                raise SystemExit(f"bad -fault spec {self.fault!r}: {e}")

    def exchange_mode(self) -> str:
        """The effective exchange ('halo' | 'allgather' | 'ring')."""
        return self.exchange or ("halo" if self.halo else "allgather")

    def mem_budget_bytes(self) -> int:
        """-mem-budget in bytes (0 = unset: the card's memory)."""
        return parse_size(self.mem_budget)

    def stream_budget_bytes(self) -> int:
        """-stream-budget in bytes (0 = unset: no in-core gate)."""
        return parse_size(self.stream_budget)

    def profile_window(self) -> tuple:
        """-profile-epochs "START:COUNT" -> (start_offset, count), START
        relative to the train() call's first epoch; "" is "3:3"."""
        spec = self.profile_epochs or "3:3"
        try:
            start_s, count_s = spec.split(":")
            start, count = int(start_s), int(count_s)
            if start < 0 or count < 1:
                raise ValueError
        except ValueError:
            raise SystemExit(f"bad profile_epochs {spec!r} "
                             "(want START:COUNT, e.g. 0:1 or 3:3)")
        return start, count


def parse_args(argv: List[str]) -> Config:
    p = argparse.ArgumentParser(
        prog="roc_tpu_torch",
        description="full-graph GNN training on one NVIDIA GPU (-parts N: "
                    "N parts on it)")
    p.add_argument("-file", dest="filename", default="")
    p.add_argument("-dataset", default="")
    p.add_argument("-layers", default="",
                   help="dash-separated widths, e.g. 602-256-41")
    p.add_argument("-e", "-epoch", dest="num_epochs", type=int, default=1)
    p.add_argument("-lr", dest="learning_rate", type=float, default=0.01)
    p.add_argument("-dropout", dest="dropout_rate", type=float, default=0.5)
    p.add_argument("-decay", "-wd", dest="weight_decay", type=float,
                   default=0.05)
    p.add_argument("-decay-rate", dest="decay_rate", type=float, default=1.0)
    p.add_argument("-decay-step", "-ds", dest="decay_steps", type=int,
                   default=100)
    p.add_argument("-seed", type=int, default=1)
    p.add_argument("-parts", "-ng", "-ll:gpu", dest="num_parts", type=int,
                   default=1)
    p.add_argument("-model", default="gcn",
                   choices=["gcn", "gcn-chain", "sage", "gin", "gat"])
    p.add_argument("-heads", type=int, default=8)
    p.add_argument("-aggr", default="",
                   choices=["", "sum", "avg", "max", "min"])
    p.add_argument("-aggr-precision", dest="aggregate_precision",
                   default="fast", choices=["exact", "fast"])
    p.add_argument("-aggr-backend", dest="aggregate_backend", default="auto",
                   choices=list(BACKENDS))
    p.add_argument("-v", dest="verbose", action="store_true")
    p.add_argument("-eval-every", dest="eval_every", type=int, default=5)
    p.add_argument("-ckpt", dest="checkpoint_path", default=None)
    p.add_argument("-ckpt-every", dest="checkpoint_every", type=int,
                   default=0)
    p.add_argument("-resume", action="store_true")
    p.add_argument("-megafuse", dest="megafuse", action="store_true",
                   help="run each aggregate->linear(->relu) layer as one "
                        "megakernel, forward and backward")
    p.add_argument("-fusion-depth", dest="fusion_depth", type=int,
                   default=1,
                   help="cross-layer fusion-region cap (needs -megafuse): "
                        "1 per-layer only (default), 2 chain two layers, "
                        "0 full chain")
    p.add_argument("-autotune", dest="autotune", action="store_true",
                   help="sweep this graph's kernel launch configurations "
                        "and keep the winners in the tuned store "
                        "(roc_tpu_torch/tune)")
    p.add_argument("-analyze", dest="analyze", action="store_true",
                   help="roc_tpu's audit of its lowered XLA steps; the "
                        "port has none and refuses it")
    p.add_argument("-lazy", dest="lazy_load", action="store_true")
    p.add_argument("-reorder", nargs="?", const="on", default="off",
                   choices=["on", "off", "auto"])
    p.add_argument("-bf16", dest="use_bf16", action="store_true")
    p.add_argument("-bf16-storage", dest="bf16_storage",
                   action="store_true")
    p.add_argument("-bf16-rounding", dest="bf16_rounding",
                   default="nearest", choices=["nearest", "stochastic"])
    p.add_argument("-bf16-exchange", dest="bf16_exchange",
                   default="plain", choices=["plain", "compensated"])
    p.add_argument("-no-halo", dest="halo", action="store_false")
    p.add_argument("-no-halo-overlap", dest="halo_overlap",
                   action="store_false")
    p.add_argument("-exchange", dest="exchange", default="",
                   choices=["", "halo", "allgather", "ring"])
    p.add_argument("-check-sharding", dest="check_sharding",
                   action="store_true")
    p.add_argument("-multihost", action="store_true")
    p.add_argument("-perhost", dest="perhost_load", action="store_true")
    p.add_argument("-edge-shard", dest="edge_shard", nargs="?", const="on",
                   default="auto", choices=["on", "off", "auto"])
    p.add_argument("-balance-every", dest="balance_every", type=int,
                   default=0)
    p.add_argument("-balance-min-gain", dest="balance_min_gain", type=float,
                   default=0.05)
    p.add_argument("-balance-trace", dest="balance_trace", default="")
    p.add_argument("-profile", dest="profile_dir", default="")
    p.add_argument("-profile-epochs", dest="profile_epochs", default="",
                   help="profiler window START:COUNT relative to the first "
                        "epoch (default 3:3)")
    p.add_argument("-obs", action="store_true",
                   help="runtime observability: host spans, per-epoch "
                        "metrics and the perf watchdog (roc_tpu_torch/obs)")
    p.add_argument("-obs-dir", dest="obs_dir", default="",
                   help="obs artifact dir (default roc_obs)")
    p.add_argument("-mem-plan", dest="mem_plan", default="keep",
                   choices=["keep", "auto", "remat"])
    p.add_argument("-mem-budget", dest="mem_budget", default="",
                   help="per-device budget for -mem-plan auto "
                        "(e.g. 6g, 512m)")
    p.add_argument("-stream", action="store_true",
                   help="out-of-core streaming executor: shards rotate "
                        "through device slots with double-buffered "
                        "prefetch (roc_tpu_torch/stream)")
    p.add_argument("-stream-slots", dest="stream_slots", type=int,
                   default=2, help="prefetch ring depth (default 2)")
    p.add_argument("-stream-budget", dest="stream_budget", default="",
                   help="device budget the in-core path is held to "
                        "(e.g. 8g); larger graphs must -stream")
    p.add_argument("-stream-spill", dest="stream_spill", default="",
                   help="spill directory for boundary stores: the third "
                        "rotation tier (memmaps on disk) when even host "
                        "memory cannot hold the boundary activations")
    p.add_argument("-serve-batch", dest="serve_batch", type=int, default=64,
                   help="serving microbatch cap: window drains at this "
                        "many queries; bucket ladder tops out here")
    p.add_argument("-serve-wait-ms", dest="serve_wait_ms", type=float,
                   default=2.0, help="max ms a serving window waits to "
                        "fill before draining (0 = drain per request)")
    p.add_argument("-serve-queue-max", dest="serve_queue_max", type=int,
                   default=4096, help="max pending serve requests before "
                        "submits shed with Overloaded (0 = unbounded)")
    p.add_argument("-fault", default="",
                   help="fault-injection spec (roc_tpu_torch/fault), e.g. "
                        "'seed=3,step.nan=1'; empty = off")
    p.add_argument("-device", default="cuda",
                   help="cuda (default) or cpu")
    ns = p.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name)
                    for f in dataclasses.fields(Config)
                    if f.name != "layers" and hasattr(ns, f.name)})
    if ns.layers:
        cfg.layers = [int(x) for x in ns.layers.split("-")]
    return cfg
