"""The port's Config and CLI (roc_tpu_torch/train/config.py) against
roc_tpu's: every flag both packages share parses to the same field values,
the environment mirrors set the same fields, and each refusal exits with
SystemExit in both."""

import pytest

from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.config import parse_args as jparse_args
from roc_tpu_torch.train.config import Config, parse_args

# every flag the two CLIs share, each with a value other than its default,
# and the field it sets
SHARED = [
    (["-dataset", "reddit"], "dataset"),
    (["-file", "data/karate"], "filename"),
    (["-layers", "602-256-41"], "layers"),
    (["-e", "10"], "num_epochs"),
    (["-lr", "0.02"], "learning_rate"),
    (["-dropout", "0.3"], "dropout_rate"),
    (["-decay", "0.0001"], "weight_decay"),
    (["-decay-rate", "0.9"], "decay_rate"),
    (["-ds", "7"], "decay_steps"),
    (["-seed", "3"], "seed"),
    (["-model", "gat"], "model"),
    (["-heads", "4"], "heads"),
    (["-aggr", "avg"], "aggr"),
    (["-aggr-precision", "exact"], "aggregate_precision"),
    (["-aggr-backend", "binned"], "aggregate_backend"),
    (["-v"], "verbose"),
    (["-eval-every", "2"], "eval_every"),
    (["-ckpt", "c.npz"], "checkpoint_path"),
    (["-ckpt-every", "4"], "checkpoint_every"),
    (["-resume"], "resume"),
    (["-megafuse"], "megafuse"),
    (["-fusion-depth", "0"], "fusion_depth"),
    (["-lazy"], "lazy_load"),
    (["-reorder", "auto"], "reorder"),
    (["-bf16"], "use_bf16"),
    (["-bf16-storage"], "bf16_storage"),
    (["-profile", "prof"], "profile_dir"),
    (["-profile-epochs", "0:2"], "profile_epochs"),
    (["-obs"], "obs"),
    (["-obs-dir", "o"], "obs_dir"),
    (["-serve-batch", "16"], "serve_batch"),
    (["-serve-wait-ms", "0.5"], "serve_wait_ms"),
    (["-serve-queue-max", "9"], "serve_queue_max"),
    (["-fault", "seed=3,step.nan=1"], "fault"),
    (["-autotune"], "autotune"),
    (["-analyze"], "analyze"),
]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("ROC_BF16_STORAGE", "ROC_SERVE_BATCH", "ROC_SERVE_WAIT_MS",
                "ROC_SERVE_QUEUE_MAX", "ROC_FAULT", "ROC_OBS", "ROC_OBS_DIR",
                "ROC_PROFILE_EPOCHS", "ROC_MEGAFUSE", "ROC_FUSION_DEPTH",
                "ROC_AUTOTUNE"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("argv,field", SHARED, ids=[a[0] for a, _ in SHARED])
def test_shared_flag_parses_as_roc_tpu(argv, field):
    ours, ref = parse_args(argv), jparse_args(argv)
    assert getattr(ours, field) == getattr(ref, field)
    assert getattr(ours, field) != getattr(parse_args([]), field)
    # and every other shared field keeps the same value in both
    for _, other in SHARED:
        assert getattr(ours, other) == getattr(ref, other), other


def test_all_shared_flags_at_once():
    argv = [a for flag, _ in SHARED for a in flag
            if flag[0] not in ("-aggr-precision",)]
    ours, ref = parse_args(argv), jparse_args(argv)
    for _, field in SHARED:
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.obs_dir == "o" and ours.use_bf16 and ours.bf16_storage


def test_defaults_match_roc_tpu():
    ours, ref = parse_args([]), jparse_args([])
    for _, field in SHARED:
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.profile_window() == ref.profile_window() == (3, 3)


# environment variable, value, field, the value it sets
ENV = [("ROC_BF16_STORAGE", "1", "bf16_storage", True),
       ("ROC_SERVE_BATCH", "32", "serve_batch", 32),
       ("ROC_SERVE_WAIT_MS", "0.25", "serve_wait_ms", 0.25),
       ("ROC_SERVE_QUEUE_MAX", "0", "serve_queue_max", 0),
       ("ROC_FAULT", "seed=3,step.nan=1", "fault", "seed=3,step.nan=1"),
       ("ROC_OBS", "1", "obs", True),
       ("ROC_OBS_DIR", "/tmp/elsewhere", "obs_dir", "/tmp/elsewhere"),
       ("ROC_PROFILE_EPOCHS", "5:2", "profile_epochs", "5:2"),
       ("ROC_MEGAFUSE", "1", "megafuse", True),
       ("ROC_FUSION_DEPTH", "0", "fusion_depth", 0),
       ("ROC_AUTOTUNE", "1", "autotune", True)]


@pytest.mark.parametrize("var,value,field,want", ENV,
                         ids=[e[0] for e in ENV])
def test_env_mirror_matches_roc_tpu(monkeypatch, var, value, field, want):
    monkeypatch.setenv(var, value)
    ours, ref = Config(), JConfig()
    assert getattr(ours, field) == getattr(ref, field) == want
    if var == "ROC_OBS":
        assert ours.obs_dir == ref.obs_dir == "roc_obs"
        monkeypatch.setenv("ROC_OBS", "0")
        assert not Config().obs and not JConfig().obs


# (Config keyword arguments, environment) that both packages refuse
REFUSED = {
    "serve_batch_0": ({"serve_batch": 0}, {}),
    "serve_wait_ms_negative": ({"serve_wait_ms": -1.0}, {}),
    "serve_queue_max_negative": ({"serve_queue_max": -1}, {}),
    "serve_batch_env": ({}, {"ROC_SERVE_BATCH": "many"}),
    "serve_wait_ms_env": ({}, {"ROC_SERVE_WAIT_MS": "soon"}),
    "serve_queue_max_env": ({}, {"ROC_SERVE_QUEUE_MAX": "1.5"}),
    "fault_spec": ({"fault": "nonsense"}, {}),
    "fault_spec_env": ({}, {"ROC_FAULT": "lux.read=-1"}),
    "fault_prob": ({"fault": "lux.read@1.5"}, {}),
    "bf16_storage_exact": ({"bf16_storage": True,
                            "aggregate_precision": "exact"}, {}),
    "bf16_storage_env_exact": ({"aggregate_precision": "exact"},
                               {"ROC_BF16_STORAGE": "1"}),
    "profile_epochs": ({"profile_epochs": "nope"}, {}),
    "profile_epochs_env": ({}, {"ROC_PROFILE_EPOCHS": "-1:2"}),
    "fusion_depth": ({"fusion_depth": -1}, {}),
    "fusion_depth_env": ({}, {"ROC_FUSION_DEPTH": "-1"}),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusal_exits_in_both_packages(monkeypatch, case):
    kw, env = REFUSED[case]
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    for make in (Config, JConfig):
        with pytest.raises(SystemExit):
            make(**kw)


def test_profile_window_parsing(monkeypatch):
    """As tests/test_obs.py:374 holds roc_tpu's."""
    assert Config().profile_window() == (3, 3)
    assert Config(profile_epochs="0:1").profile_window() == (0, 1)
    for bad in ("nope", "3", "-1:2", "1:0"):
        with pytest.raises(SystemExit):
            Config(profile_epochs=bad)
    monkeypatch.setenv("ROC_PROFILE_EPOCHS", "5:2")
    assert Config().profile_window() == JConfig().profile_window() == (5, 2)
