"""The port's serving slice as a whole against the JAX package, on the CPU.

A narrow AlexNet-shaped net (the layer list of
examples/imagenet/alexnet.conf with space_to_depth, a few channels, a
67x67 input) runs through ``cxxnet_tpu.model.Network.apply`` (its Pallas
conv and LRN in interpret mode) and through the port, with the same
numpy weights carried across by ``weights.from_jax_params`` and the
same inputs, all drawn from ``np.random.default_rng``. Then: checkpoints
written by either package load in the other, the port's engine and
HTTP server answer like a direct forward, devices are picked as the
port promises, and no module of the port imports jax or cxxnet_tpu.
"""

import ast
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu import checkpoint as jckpt
from cxxnet_tpu import config as jconfig
from cxxnet_tpu.graph import NetConfig as JNetConfig
from cxxnet_tpu.layers import s2d_pack as j_s2d_pack
from cxxnet_tpu.model import Network as JNetwork
from cxxnet_tpu_torch import checkpoint as tckpt
from cxxnet_tpu_torch import config as tconfig
from cxxnet_tpu_torch import device as tdevice
from cxxnet_tpu_torch import weights
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.graph import NetConfig as TNetConfig
from cxxnet_tpu_torch.model import Network as TNetwork
from cxxnet_tpu_torch.serve.engine import ServingEngine
from cxxnet_tpu_torch.serve.server import build_server
from cxxnet_tpu_torch.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4

NARROW_ALEXNET = """
netconfig=start
layer[0->1] = conv:conv1
  kernel_size = 11
  stride = 4
  nchannel = 8
  space_to_depth = 4
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 3
  stride = 2
layer[3->4] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[4->5] = conv:conv2
  ngroup = 2
  kernel_size = 5
  pad = 2
  nchannel = 16
layer[5->6] = relu
layer[6->7] = max_pooling
  kernel_size = 3
  stride = 2
layer[7->8] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[8->9] = conv:conv3
  kernel_size = 3
  pad = 1
  nchannel = 24
layer[9->10] = relu
layer[10->11] = conv:conv4
  ngroup = 2
  kernel_size = 3
  pad = 1
  nchannel = 24
layer[11->12] = relu
layer[12->13] = conv:conv5
  ngroup = 2
  kernel_size = 3
  pad = 1
  nchannel = 16
  init_bias = 1.0
layer[13->14] = relu
layer[14->15] = max_pooling
  kernel_size = 3
  stride = 2
layer[15->16] = flatten
layer[16->17] = fullc:fc6
  nhidden = 32
layer[17->18] = relu
layer[18->18] = dropout
  threshold = 0.5
layer[18->19] = fullc:fc7
  nhidden = 32
layer[19->20] = relu
layer[20->20] = dropout
  threshold = 0.5
layer[20->21] = fullc:fc8
  nhidden = 10
layer[21->21] = softmax
netconfig=end
input_shape = 3,67,67
batch_size = 4
conv_impl = pallas
lrn_impl = pallas
"""
OUT = 21


def _pairtest_metric(m: np.ndarray, s: np.ndarray) -> float:
    """sum|m - s| / sum|m| (cxxnet_tpu/pairtest.py:36)."""
    return float(np.abs(m - s).sum() / max(np.abs(m).sum(), 1e-30))


def _entries(dtype, extra=()):
    return jconfig.parse_string(NARROW_ALEXNET) + [("dtype", dtype)] \
        + list(extra)


def _numpy_params(jnet, seed=0):
    """The JAX net's parameter structure filled from numpy: He-scaled
    weights over each wmat's fan-in (its last axis), small biases."""
    shapes = jax.eval_shape(jnet.init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    out = []
    for p in shapes:
        if p is None:
            out.append(None)
            continue
        out.append({
            tag: (rng.normal(0.0, np.sqrt(2.0 / s.shape[-1]), s.shape)
                  if tag == "wmat" else rng.normal(0.0, 0.05, s.shape)
                  ).astype(np.float32)
            for tag, s in p.items()})
    return out


def _data(seed=1, n=BATCH):
    return np.random.default_rng(seed).normal(
        0.0, 1.0, (n, 3, 67, 67)).astype(np.float32)


_JAX_RUNS = {}


def _jax_run(dtype):
    """(net config, numpy params, data, {node: value}) of one JAX
    forward, cached per dtype: interpret-mode Pallas compiles slowly."""
    if dtype not in _JAX_RUNS:
        cfg = JNetConfig()
        cfg.configure(_entries(dtype))
        jnet = JNetwork(cfg, BATCH, compute_dtype=dtype)
        jnet.platform = "cpu"
        params = _numpy_params(jnet)
        data = _data()
        values, _ = jnet.apply(
            jax.tree.map(jnp.asarray, params),
            jnp.asarray(j_s2d_pack(data, 4)))
        _JAX_RUNS[dtype] = (cfg, params, data, {
            k: np.asarray(v, np.float32) for k, v in values.items()})
    return _JAX_RUNS[dtype]


def _port_trainer(dtype="float32", dev="cpu", extra=()):
    tr = Trainer()
    for k, v in tconfig.parse_string(NARROW_ALEXNET) + [
            ("dtype", dtype), ("dev", dev)] + list(extra):
        tr.set_param(k, v)
    return tr


# ----------------------------------------------------------------------
# whole-net parity with the JAX package

def test_slice_matches_jax_float32_on_every_node():
    _, params, data, ref = _jax_run("float32")
    cfg = TNetConfig()
    cfg.configure(tconfig.parse_string(NARROW_ALEXNET))
    net = TNetwork(cfg, BATCH, compute_dtype="float32")
    from cxxnet_tpu_torch.layers import s2d_pack
    values = net.apply(weights.from_jax_params(params),
                       torch.from_numpy(s2d_pack(data, 4)))
    assert sorted(values) == sorted(ref)
    for ni in ref:
        got = values[ni].numpy()
        assert got.shape == ref[ni].shape, ni
        # f32 end to end: the pairtest bound
        assert _pairtest_metric(ref[ni], got) <= 1e-5, ni
    assert (values[OUT].reshape(BATCH, -1).argmax(1).numpy()
            == ref[OUT].reshape(BATCH, -1).argmax(1)).all()


def test_slice_matches_jax_bfloat16():
    _, params, data, ref = _jax_run("bfloat16")
    tr = _port_trainer("bfloat16")
    tr.init_model()
    tr.params = weights.from_jax_params(params)
    got = tr.forward_nodes(data, [OUT])[0]
    # the same bf16 rounding points in both packages; the f32 sums
    # between them are taken in another order, so a rounding can flip
    # by one bf16 ulp — a looser bound than float32's, same argmax
    assert _pairtest_metric(ref[OUT], got) <= 2e-3
    assert (got.reshape(BATCH, -1).argmax(1)
            == ref[OUT].reshape(BATCH, -1).argmax(1)).all()


def test_forward_nodes_packs_on_host_and_unpacks_the_data_node():
    _, params, data, ref = _jax_run("float32")
    tr = _port_trainer()
    tr.init_model()
    tr.params = weights.from_jax_params(params)
    assert tr.net.input_s2d == 4
    node0, out = tr.forward_nodes(data, [0, OUT])
    np.testing.assert_array_equal(node0, data)
    assert _pairtest_metric(ref[OUT], out) <= 1e-5


# ----------------------------------------------------------------------
# checkpoints cross both ways

def test_jax_checkpoint_serves_equal_predictions_in_port(tmp_path):
    cfg, params, data, ref = _jax_run("float32")
    path = str(tmp_path / "0003.model")
    jckpt.save_model(path, cfg, 3, params)
    pcfg, epoch, pparams, _, _ = tckpt.load_model(path)
    assert pcfg.structure_state() == cfg.structure_state() and epoch == 3
    for a, b in zip(params, pparams):
        assert (a is None) == (b is None)
        for tag in a or {}:
            np.testing.assert_array_equal(a[tag], b[tag])
    bogus = tmp_path / "bogus.model"
    bogus.write_text("not a zip")
    with pytest.raises(ValueError, match="not a cxxnet_tpu"):
        tckpt.load_model(str(bogus))
    tr = _port_trainer()
    tr.load_model(path)
    assert tr.epoch_counter == 3
    out = tr.forward_nodes(data, [OUT])[0]
    assert _pairtest_metric(ref[OUT], out) <= 1e-5
    assert (out.reshape(BATCH, -1).argmax(1)
            == ref[OUT].reshape(BATCH, -1).argmax(1)).all()


def test_port_checkpoint_loads_in_jax(tmp_path):
    tr = _port_trainer(extra=[("seed", "5")])
    tr.init_model()
    path = str(tmp_path / "port.model")
    tr.save_model(path)
    cfg, epoch, params, opt_state, _ = jckpt.load_model(path)
    assert cfg.structure_state() == tr.net_cfg.structure_state()
    assert opt_state is None
    mine = weights.to_jax_params(tr.params)
    assert len(params) == len(mine)
    for a, b in zip(params, mine):
        assert (a is None) == (b is None)
        if a is not None:
            assert sorted(a) == sorted(b)
            for tag in a:
                np.testing.assert_array_equal(a[tag], b[tag])


def test_port_init_is_seeded_and_device_independent():
    a, b, c = (_port_trainer(extra=[("seed", s)]) for s in ("1", "1", "2"))
    for tr in (a, b, c):
        tr.init_model()
    wa, wb_, wc = (weights.to_jax_params(t.params)[0]["wmat"]
                   for t in (a, b, c))
    np.testing.assert_array_equal(wa, wb_)
    assert not np.array_equal(wa, wc)


# ----------------------------------------------------------------------
# the pieces under the slice

@pytest.mark.parametrize("kind,h,k,s,pad", [
    ("max_pooling", 15, 3, 2, 0),
    ("max_pooling", 8, 3, 3, 0),     # partial bottom/right window
    ("max_pooling", 7, 3, 1, 1),     # 'same' pooling
    ("avg_pooling", 9, 2, 3, 0),
    ("sum_pooling", 8, 3, 2, 1),
])
def test_pooling_edge_rule_matches_jax(kind, h, k, s, pad):
    from cxxnet_tpu import layers as JL
    from cxxnet_tpu_torch import layers as TL
    cfg = [("kernel_size", str(k)), ("stride", str(s)), ("pad", str(pad))]
    jl, tl = JL.create_layer(kind, cfg), TL.create_layer(kind, cfg)
    shape = (2, 3, h, h + 1)
    assert jl.infer_shape([shape]) == tl.infer_shape([shape])
    x = np.random.default_rng(h * k + s).normal(size=shape).astype(
        np.float32)
    ref = np.asarray(jl.apply({}, [jnp.asarray(x)], JL.ApplyContext())[0])
    got = tl.apply({}, [torch.from_numpy(x)], TL.ApplyContext())[0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_training_and_unported_layers_raise_naming_their_slice():
    tr = _port_trainer()
    tr.init_model()
    with pytest.raises(NotImplementedError, match="training slice"):
        tr.net.apply(tr.params, torch.zeros(BATCH, 48, 17, 17), train=True)
    cfg = TNetConfig()
    cfg.configure(tconfig.parse_string(
        "netconfig=start\nlayer[0->1] = batch_norm\nnetconfig=end\n"
        "input_shape = 3,8,8\n"))
    with pytest.raises(NotImplementedError, match="training slice"):
        TNetwork(cfg, 2)


# ----------------------------------------------------------------------
# serving

def _serving_trainer():
    tr = _port_trainer(extra=[("seed", "3")])
    tr.init_model()
    return tr


def test_engine_answers_mixed_sizes_like_a_direct_forward():
    tr = _serving_trainer()
    sizes = [1, 3, 2, 5]   # 5 rows > batch 4: the chunked oversize path
    datas = [_data(seed=10 + i, n=n) for i, n in enumerate(sizes)]
    with ServingEngine(tr, max_wait_ms=20.0, queue_limit=8) as eng:
        reqs = [eng.submit(d) for d in datas]
        outs = [r.result(timeout=120) for r in reqs]
        snap = eng.metrics()
    for d, o in zip(datas, outs):
        ref = tr.forward_nodes(d, [OUT])[0]
        assert o.shape == ref.shape
        np.testing.assert_allclose(o, ref, rtol=1e-5, atol=1e-7)
    assert snap["requests"] == len(sizes)
    assert snap["rows"] == sum(sizes)


def test_engine_sheds_at_the_queue_limit_and_drains():
    from cxxnet_tpu_torch.serve.engine import DrainError, QueueFullError
    eng = ServingEngine(_serving_trainer(), queue_limit=2, start=False)
    one = _data(n=1)
    eng.submit(one)
    eng.submit(one)
    with pytest.raises(QueueFullError):
        eng.submit(one)
    assert eng.drain(timeout=0.0) == 2
    with pytest.raises(DrainError):
        eng.submit(one)
    eng.close()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_http_predict_healthz_metrics():
    tr = _serving_trainer()
    eng = ServingEngine(tr, max_wait_ms=5.0, warmup=True)
    srv = build_server(eng, port=0)
    srv.start_background()
    url = "http://127.0.0.1:%d" % srv.server_address[1]
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["batch"] == BATCH
        datas = [_data(seed=20, n=1), _data(seed=21, n=3)]
        answers = [None, None]

        def client(i):
            answers[i] = _post(url + "/predict", {"data": datas[i].tolist()})
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for d, (status, body) in zip(datas, answers):
            assert status == 200 and body["request_id"].startswith("req-")
            ref = tr.forward_nodes(d, [OUT])[0]
            out = np.asarray(body["output"], np.float32)
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)
            assert body["pred"] == list(ref.reshape(len(d), -1).argmax(1))
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(url + "/predict", {"data": [[1.0, 2.0]]})
        assert bad.value.code == 400
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
        assert metrics["requests"] == 2 and metrics["rows"] == 4
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()


def test_cli_serves_a_jax_checkpoint(tmp_path):
    cfg, params, data, ref = _jax_run("float32")
    ckpt = str(tmp_path / "0001.model")
    jckpt.save_model(ckpt, cfg, 1, params)
    conf = tmp_path / "narrow.conf"
    conf.write_text(NARROW_ALEXNET)
    task = LearnTask()
    task.configure([str(conf), "task=serve", "model_in=" + ckpt,
                    "dev=cpu", "serve_port=0", "silent=1"])
    task.init()
    srv = task.start_serving()
    srv.start_background()
    try:
        status, body = _post("http://127.0.0.1:%d/predict"
                             % srv.server_address[1],
                             {"data": data[:2].tolist()})
    finally:
        srv.shutdown()
        task.close()
    assert status == 200
    out = np.asarray(body["output"], np.float32)
    assert _pairtest_metric(ref[OUT][:2], out) <= 1e-5


@pytest.mark.parametrize("argv,err", [
    (["task=train"], NotImplementedError),
    (["task=serve", "export_in=x.bin"], NotImplementedError),
    (["task=serve"], RuntimeError),              # no model_in
])
def test_cli_refuses_what_this_slice_does_not_run(tmp_path, argv, err):
    conf = tmp_path / "narrow.conf"
    conf.write_text(NARROW_ALEXNET)
    task = LearnTask()
    task.configure([str(conf)] + argv)
    with pytest.raises(err):
        task.init()


# ----------------------------------------------------------------------
# devices and imports

def test_accelerator_devs_need_cuda_and_cpu_is_explicit(monkeypatch):
    assert tdevice.parse_device_config("gpu:1,2") == ("gpu", [1, 2])
    assert tdevice.parse_device_config("tpu:0-3") == ("tpu", [0, 1, 2, 3])
    assert tdevice.select_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in ("tpu", "gpu:0", "tpu:0-3", "cuda"):
        with pytest.raises(RuntimeError, match="dev=cpu"):
            tdevice.select_device(dev)
    tr = Trainer()   # the default dev is the accelerator
    for k, v in tconfig.parse_string(NARROW_ALEXNET):
        tr.set_param(k, v)
    with pytest.raises(RuntimeError):
        tr.init_model()


def _port_sources():
    pkg = os.path.join(REPO, "cxxnet_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_cxxnet_tpu():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "cxxnet_tpu"):
                    bad.append("%s: %s" % (os.path.relpath(path, REPO),
                                           name))
    assert not bad, bad
