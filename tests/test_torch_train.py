"""The port's training slice against the JAX package, on the CPU.

The narrow AlexNet of tests/test_torch_slice.py, with dropout's
threshold set to 0 so both packages run the same function, trains from
one checkpoint written by the JAX package (numpy weights) on the same
synthetic batches: ``cxxnet_tpu.trainer.Trainer`` runs its conv and LRN
through the Pallas kernels in interpret mode, the port through its
autograd Functions (on the CPU, the hand kernels' plain versions). Then:
the CLI ``task=train`` of each package prints the same metric lines and
each resumes from the other's checkpoint, optimizer slots included;
dropout keeps and scales as the JAX layer does (its bits cannot match:
the JAX layer draws threefry keys, the port a torch.Generator); the
updaters' schedules and steps match the JAX package's.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu import checkpoint as jckpt
from cxxnet_tpu import config as jconfig
from cxxnet_tpu import updater as jupdater
from cxxnet_tpu.cli import LearnTask as JLearnTask
from cxxnet_tpu.graph import NetConfig as JNetConfig
from cxxnet_tpu.io import DataBatch as JDataBatch
from cxxnet_tpu.layers import ApplyContext as JApplyContext
from cxxnet_tpu.layers import create_layer as jcreate_layer
from cxxnet_tpu.model import Network as JNetwork
from cxxnet_tpu.trainer import Trainer as JTrainer
from cxxnet_tpu_torch import checkpoint as tckpt
from cxxnet_tpu_torch import config as tconfig
from cxxnet_tpu_torch import layers as TL
from cxxnet_tpu_torch import updater as tupdater
from cxxnet_tpu_torch import weights
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.io import DataBatch, create_iterator
from cxxnet_tpu_torch.trainer import Trainer

from test_torch_slice import BATCH, NARROW_ALEXNET, _numpy_params

NET = NARROW_ALEXNET.replace("threshold = 0.5", "threshold = 0")
FC8 = 22   # the classifier's layer index
TRAIN = """
eta = 0.01
momentum = 0.9
wd = 0.0005
lr:schedule = expdecay
lr:gamma = 0.5
lr:step = 1
metric[label] = error
metric[label] = rec@5
"""
SYNTH = """
data = train
iter = synth
  shape = 3,67,67
  nclass = 10
  ninst = 8
iter = end
eval = val
iter = synth
  shape = 3,67,67
  nclass = 10
  ninst = 4
iter = end
"""


def _pairtest(m, s) -> float:
    """sum|m - s| / sum|m| (cxxnet_tpu/pairtest.py:36)."""
    m, s = np.asarray(m, np.float64), np.asarray(s, np.float64)
    return float(np.abs(m - s).sum() / max(np.abs(m).sum(), 1e-30))


def _entries(dtype):
    return jconfig.parse_string(NET + TRAIN) + [("dtype", dtype)]


def _start_params(dtype):
    """(JAX net config, numpy weights): He-scaled, the classifier's
    weights scaled down so the first loss is ~ln(10), as at a real
    start."""
    cfg = JNetConfig()
    cfg.configure(_entries(dtype))
    jnet = JNetwork(cfg, BATCH, compute_dtype=dtype)
    params = _numpy_params(jnet, seed=2)
    params[FC8]["wmat"] *= 0.05
    return cfg, params


def _start_checkpoint(path, dtype):
    """The JAX package's checkpoint of the start weights, at round 1."""
    cfg, params = _start_params(dtype)
    jckpt.save_model(str(path), cfg, 1, params)


def _batches(n=3):
    rng = np.random.default_rng(5)
    return [(rng.normal(0.0, 1.0, (BATCH, 3, 67, 67)).astype(np.float32),
             rng.integers(0, 10, (BATCH, 1)).astype(np.float32))
            for _ in range(n)]


def _jax_step(jtr, data, label) -> float:
    """One JAX training step as Trainer.update takes it (trainer.py:
    1016-1053), returning the step's loss, which update() drops."""
    dev = jtr._put_batch(JDataBatch(data, label))
    (jtr.params, jtr.opt_state, jtr._rng, jtr._epoch_dev, jtr._maccum,
     loss) = jtr._train_step(jtr.params, jtr.opt_state, jtr._rng,
                             jtr._epoch_dev, jtr._maccum, *dev)
    jtr.epoch_counter += 1
    return float(loss)


# (loss, weights, the weights' three updates alone), pairtest metric.
# f32: the pairtest bound (the updates: 1e-4, their sums are small
# differences of the weights). bf16: the port rounds where the JAX layers
# round (test_bf16_step_matches_jax_rounding_points holds one step to
# 1e-5), but under jit XLA folds the fc layers' bf16 rounding into an
# f32-output dot, so the trainer's fc outputs keep f32 bits the eager
# layers drop; through three steps that moves the loss by up to 5e-4, the
# weights by 1.6e-3 and their updates by 6.5e-2 (measured), bounded at
# 2e-3, 5e-3 and 0.15
BOUNDS = {"float32": (1e-5, 1e-5, 1e-4), "bfloat16": (2e-3, 5e-3, 0.15)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_sgd_steps_match_jax(tmp_path, dtype):
    ckpt = tmp_path / "0001.model"
    _start_checkpoint(ckpt, dtype)
    jtr = JTrainer()
    ptr = Trainer()
    for k, v in _entries(dtype):
        jtr.set_param(k, v)
        ptr.set_param(k, v)
    jtr.set_param("dev", "cpu:0")
    ptr.set_param("dev", "cpu")
    jtr.load_model(str(ckpt))
    ptr.load_model(str(ckpt))
    w0 = weights.to_jax_params(ptr.params)
    for data, label in _batches():
        jloss = _jax_step(jtr, data, label)
        ptr.update(DataBatch(data, label))
        loss_bound = BOUNDS[dtype][0]
        assert _pairtest(jloss, float(ptr.last_loss)) <= loss_bound
    assert ptr.epoch_counter == jtr.epoch_counter == 4
    _, w_bound, dw_bound = BOUNDS[dtype]
    jparams = jax.tree.map(np.asarray, jtr.params)
    jslots = jax.tree.map(np.asarray, jtr.opt_state)
    mine, slots = (weights.to_jax_params(ptr.params),
                   weights.to_jax_opt_state(ptr.opt_state))
    for li, (jp, tp) in enumerate(zip(jparams, mine)):
        assert (jp is None) == (tp is None)
        for tag in jp or {}:
            assert _pairtest(jp[tag], tp[tag]) <= w_bound, (li, tag)
            # the three updates alone, where the differences live
            assert _pairtest(jp[tag] - w0[li][tag],
                             tp[tag] - w0[li][tag]) <= dw_bound, (li, tag)
            assert _pairtest(jslots[li][tag]["m"],
                             slots[li][tag]["m"]) <= dw_bound, (li, tag)


def test_bf16_step_matches_jax_rounding_points():
    """One bf16 step at the network level, both packages op by op (no
    jit): the same rounding points give the same loss, node values and
    gradients, up to the order of f32 sums."""
    from cxxnet_tpu.layers import s2d_pack
    from cxxnet_tpu_torch.graph import NetConfig
    from cxxnet_tpu_torch.model import Network
    cfg, params = _start_params("bfloat16")
    jnet = JNetwork(cfg, BATCH, compute_dtype="bfloat16")
    jnet.platform = "cpu"
    data, label = _batches(1)[0]
    x = s2d_pack(data, 4)

    def loss_fn(p):
        values, loss = jnet.apply(p, jnp.asarray(x),
                                  labels=[jnp.asarray(label)], train=True,
                                  rng=jax.random.PRNGKey(0))
        return loss, values
    (jloss, jvalues), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    pcfg = NetConfig()
    pcfg.configure(tconfig.parse_string(NET + TRAIN)
                   + [("dtype", "bfloat16")])
    net = Network(pcfg, BATCH, compute_dtype="bfloat16")
    mine = weights.from_jax_params(params)
    for p in mine:
        for w in (p or {}).values():
            w.requires_grad_(True)
    values, loss = net.apply(mine, torch.from_numpy(x),
                             labels=[torch.from_numpy(label)], train=True)
    loss.backward()
    assert _pairtest(float(jloss), float(loss.detach())) <= 1e-5
    for ni, v in values.items():
        assert _pairtest(np.asarray(jvalues[ni], np.float32),
                         v.detach().float().numpy()) <= 1e-5, ni
    for li, p in enumerate(mine):
        for tag, w in (p or {}).items():
            assert _pairtest(np.asarray(jgrads[li][tag]),
                             w.grad.numpy()) <= 1e-5, (li, tag)


# ----------------------------------------------------------------------
# the CLI of both packages, and checkpoints that resume across

def _round_lines(err: str):
    """The metric lines: the evaluation before the first round (a
    model_in start) and one per round."""
    return [ln for ln in err.splitlines() if "-error:" in ln]


def _run_cli(task_cls, argv, capsys):
    capsys.readouterr()
    task_cls().run(argv)
    return _round_lines(capsys.readouterr().err)


def test_cli_train_prints_jax_lines_and_resumes_across(tmp_path, capsys):
    conf = tmp_path / "narrow.conf"
    conf.write_text(NET + TRAIN + SYNTH)
    start = tmp_path / "0001.model"
    _start_checkpoint(start, "float32")
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    common = [str(conf), "num_round=3", "silent=1", "print_step=0"]
    jl = _run_cli(JLearnTask, common + [
        "model_in=%s" % start, "model_dir=%s" % jdir, "dev=cpu:0"], capsys)
    pl = _run_cli(LearnTask, common + [
        "model_in=%s" % start, "model_dir=%s" % pdir, "dev=cpu"], capsys)
    # the evaluation of the start, then rounds 2 and 3
    assert len(jl) == 3 and jl[1].startswith("[2]") \
        and jl[2].startswith("[3]")
    assert pl == jl
    assert re.search(r"\ttrain-rec@5:[0-9.]+\tval-error:", pl[1])

    # each package resumes from the other's round-3 checkpoint
    jmodel, pmodel = jdir / "0003.model", pdir / "0003.model"
    ptr = Trainer()
    for k, v in tconfig.parse_string(NET + TRAIN) + [("dev", "cpu")]:
        ptr.set_param(k, v)
    ptr.load_model(str(jmodel))
    _, epoch, _, jslots, _ = jckpt.load_model(str(jmodel))
    assert ptr.epoch_counter == epoch == 5
    for li, s in enumerate(jslots):
        for tag, slot in (s or {}).items():
            np.testing.assert_array_equal(
                ptr.opt_state[li][tag]["m"].numpy(), slot["m"])
    assert tckpt.load_model(str(pmodel))[3] is not None
    more = ["num_round=4", "model_dir=%s" % (tmp_path / "resumed")]
    jl4 = _run_cli(JLearnTask, common[:1] + common[2:] + more + [
        "model_in=%s" % pmodel, "dev=cpu:0"], capsys)
    pl4 = _run_cli(LearnTask, common[:1] + common[2:] + more + [
        "model_in=%s" % jmodel, "dev=cpu"], capsys)
    assert len(pl4) == 2 and pl4[1].startswith("[4]")
    assert pl4 == jl4


def test_port_cli_continues_from_its_newest_checkpoint(tmp_path, capsys):
    conf = tmp_path / "narrow.conf"
    conf.write_text(NET + TRAIN + SYNTH)
    mdir = tmp_path / "models"
    argv = [str(conf), "dev=cpu", "silent=1", "model_dir=%s" % mdir]
    first = _run_cli(LearnTask, argv + ["num_round=1", "seed=3"], capsys)
    # a fresh start saves round 0 before training, then round 1
    assert sorted(p.name for p in mdir.iterdir()) == ["0000.model",
                                                     "0001.model"]
    assert len(first) == 1 and first[0].startswith("[1]")
    again = _run_cli(LearnTask, argv + ["num_round=2", "continue=1"],
                     capsys)
    assert len(again) == 2 and again[1].startswith("[2]")
    assert tckpt.load_model(str(mdir / "0002.model"))[1] == 4


@pytest.mark.parametrize("argv", [["task=train", "update_period=2"],
                                  ["task=train", "fuse_steps=2"],
                                  ["task=train", "nan_guard=1"]])
def test_later_slice_training_options_raise(tmp_path, argv):
    conf = tmp_path / "narrow.conf"
    conf.write_text(NET + TRAIN + SYNTH)
    task = LearnTask()
    task.configure([str(conf), "dev=cpu"] + argv)
    with pytest.raises(NotImplementedError, match="CNN zoo and data"):
        task.init()


# ----------------------------------------------------------------------
# iterators

def test_synth_iterator_gives_the_jax_batches():
    from cxxnet_tpu.io import create_iterator as jcreate_iterator
    cfg = [("iter", "synth"), ("shape", "3,9,9"), ("nclass", "7"),
           ("ninst", "10"), ("iter", "threadbuffer")]
    defaults = [("batch_size", "4"), ("seed", "3")]
    mine = list(b for b in create_iterator(cfg, defaults))
    ref = list(b for b in jcreate_iterator(cfg, defaults))
    assert len(mine) == len(ref) == 3
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.label, b.label)
        assert a.num_batch_padd == b.num_batch_padd
    with pytest.raises(NotImplementedError, match="CNN zoo and data"):
        create_iterator([("iter", "imgbin")])


# ----------------------------------------------------------------------
# dropout

def test_dropout_keeps_and_scales_as_jax_and_a_seed_fixes_the_mask():
    shape = (50, 1, 40, 50)          # 100k elements
    layer = TL.create_layer("dropout", [("threshold", "0.3")])
    layer.infer_shape([shape])
    x = torch.ones(shape)

    def mask(seed, train=True):
        ctx = TL.ApplyContext(train=train,
                              generator=torch.Generator().manual_seed(seed))
        return layer.apply({}, [x], ctx)[0]
    a, b, c = mask(1), mask(1), mask(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(mask(1, train=False), x)
    kept = (a != 0).float().mean().item()
    # keep rate 0.7: within 5 sigma of 100k Bernoulli draws
    assert abs(kept - 0.7) < 5 * np.sqrt(0.7 * 0.3 / x.numel())
    assert torch.allclose(a[a != 0], torch.tensor(1.0 / 0.7))
    jl = jcreate_layer("dropout", [("threshold", "0.3")])
    jl.infer_shape([shape])
    jout = np.asarray(jl.apply({}, [jnp.ones(shape)], JApplyContext(
        train=True, rng=jax.random.PRNGKey(0)))[0])
    assert abs((jout != 0).mean() - kept) < 10 * np.sqrt(
        0.7 * 0.3 / x.numel())
    np.testing.assert_allclose(jout[jout != 0], 1.0 / 0.7, rtol=1e-6)


# ----------------------------------------------------------------------
# updaters

SCHEDULES = [
    [],
    [("lr:schedule", "expdecay"), ("lr:gamma", "0.92"), ("lr:step", "7")],
    [("lr:schedule", "polydecay"), ("lr:gamma", "0.1"), ("lr:alpha", "0.7"),
     ("lr:step", "3")],
    [("lr:schedule", "factor"), ("lr:factor", "0.5"), ("lr:step", "4"),
     ("lr:minimum_lr", "0.001")],
    [("lr:schedule", "cosine"), ("lr:total", "50"), ("lr:warmup", "5")],
    [("momentum_schedule", "1"), ("saturation_epoch", "20"),
     ("base_momentum", "0.5"), ("final_momentum", "0.95"),
     ("lr:start_epoch", "3")],
    [("wmat:lr", "0.5"), ("bias:wd", "0.1")],
]


@pytest.mark.parametrize("cfg", SCHEDULES)
@pytest.mark.parametrize("tag", ["wmat", "bias"])
def test_updater_schedules_match_jax(cfg, tag):
    base = [("eta", "0.05"), ("momentum", "0.9")] + cfg
    mine = tupdater.create_tensor_updater("sgd", tag, [base]).hp
    ref = jupdater.create_tensor_updater("sgd", tag, [base]).hp
    for e in (0, 1, 2, 3, 5, 17, 49, 50, 100, 5000):
        lr, mom = mine.schedule(e)
        rlr, rmom = (float(v) for v in ref.schedule(e))
        # both float32 arithmetic; pow/cos may differ by an ulp
        assert lr == pytest.approx(rlr, rel=1e-6, abs=1e-12), e
        assert mom == pytest.approx(rmom, rel=1e-6), e


@pytest.mark.parametrize("kind,extra", [
    ("sgd", []), ("sgd", [("clip_gradient", "0.5")]), ("nag", []),
    ("adam", []), ("adam", [("decoupled_wd", "1")]),
])
def test_updater_steps_match_jax(kind, extra):
    cfg = [("eta", "0.1"), ("momentum", "0.8"), ("wd", "0.01"),
           ("lr:schedule", "expdecay"), ("lr:gamma", "0.5")] + extra
    rng = np.random.default_rng(7)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=w.shape).astype(np.float32) for _ in range(3)]
    grads[1][0, 0] = np.nan       # the clip functor zeroes NaN
    mine = tupdater.create_tensor_updater(kind, "wmat", [cfg])
    ref = jupdater.create_tensor_updater(kind, "wmat", [cfg])
    tw = torch.from_numpy(w.copy())
    ts = mine.init_state(tw)
    jw, js = jnp.asarray(w), ref.init_state(jnp.asarray(w))
    for e, g in enumerate(grads):
        if not any(k == "clip_gradient" for k, _ in extra):
            g = np.nan_to_num(g)
        mine.update_(ts, tw, torch.from_numpy(g), e)
        jw, js = ref.update(js, jw, jnp.asarray(g), e)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    for slot in js:
        np.testing.assert_allclose(ts[slot].numpy(), np.asarray(js[slot]),
                                   rtol=1e-6, atol=1e-7)


def test_clip_global_norm_rescales_the_whole_gradient():
    cfg = TNetConfigFor("clip_global_norm = 1.0\n")
    from cxxnet_tpu_torch.model import Network
    net = Network(cfg, BATCH)
    params = net.init_params(1)
    opt = tupdater.NetUpdater(net)
    state = opt.init_state(params)
    grads = [None if p is None else {t: torch.full_like(w, 10.0)
                                     for t, w in p.items()}
             for p in params]
    before = [None if p is None else {t: w.clone() for t, w in p.items()}
              for p in params]
    opt.apply_(params, grads, state, 0)
    norm = 0.0
    for p, b in zip(params, before):
        for t in p or {}:
            norm += float(((p[t] - b[t]) / -0.01).square().sum())
    # lr 0.01, first step: w' - w = -lr * g_scaled, |g_scaled| = 1
    assert norm == pytest.approx(1.0, rel=1e-4)


def TNetConfigFor(extra: str):
    from cxxnet_tpu_torch.graph import NetConfig
    cfg = NetConfig()
    cfg.configure(tconfig.parse_string(NET + "eta = 0.01\nmomentum = 0\n"
                                       + extra))
    return cfg
