"""The port's data parallelism across processes (`ganslate_tpu_torch/parallel/`,
`utils/communication.py`) on 2 gloo ranks on the CPU, held against the JAX
package on its 8-device CPU mesh (tests/conftest.py) at the same global
batch, and against one process of the port.

The ranks are child processes (`tests/torch_distributed_child.py`, one
launch for the module) that import the port only; each has 120 s of wall
time and its group a 60 s collective timeout. The JAX references are built
here: one JAX CycleGAN (`test_multihost.py`'s tiny configuration: global
batch 8, 32², 1 channel, ngf 8, 1 residual block, PatchGAN ndf 8 of 1
layer, fp32) with the image pool on (pool_size 4), two steps, so that the
pool fills and then replaces; its initial parameters and its pools' draws
(from the key the JAX step splits off its state) are handed to the port.

Tolerances:
- against JAX, the losses per step `rtol=2e-4, atol=1e-5` (as
  `test_spatial_mesh_train_step`), and the gradients of step 1 (1e-4
  relative L2) and the parameters after it (max abs 1e-5), the bounds of
  the port's one-process CycleGAN lockstep (`test_torch_port_train_step.py`):
  every conv and norm sums in another order than XLA. The parameters are
  held after step 1, component by component where the gradient decides the
  sign of Adam's update (`test_two_rank_cyclegan_step_matches_jax`);
- 2 ranks against 1 rank of the port at the global batch: losses 1e-6
  relative and every gradient 1e-6 relative L2: the same convolutions on
  halves of the batch, summed in another order (the batch mean split in two
  means, then averaged);
- batch norm against the JAX `BatchNorm` on the global batch: output and
  gradients `atol=1e-6`;
- the pool: exactly the JAX `query_pool`'s images (copies, no arithmetic);
- the sliding window: `atol=1e-5` against the JAX inferer, as
  `test_sliding_window_distributed.py` holds it against one device."""

import datetime

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch import parallel
from ganslate_tpu_torch.nn.gans.base import select_device
from ganslate_tpu_torch.utils import communication
from ganslate_tpu_torch.utils.flax_weights import load_flax_params

from tests import torch_distributed_child as child

GLOBAL, SIZE, POOL = 8, 32, 4
NETWORKS = ("G_AB", "G_BA", "D_B", "D_A")

SW_CASES = {
    # name: (volume, roi, sw batch, overlap, scale); the grid has n windows
    "volume": ((1, 12, 24, 24, 1), (4, 8, 8), 2, 0.25, 1.7),          # 64
    "images": ((2, 20, 20, 3), (8, 8), 3, 0.5, 0.9),                   # 16
    "odd-grid": ((1, 9, 20, 20, 1), (4, 8, 8), 2, 0.25, 1.3),          # 27: padded
}


def _pool_draws(key, n):
    """The `(uniform, index)` pair of each of `n` images that the JAX
    `query_pool` draws from `key`."""
    def one(k):
        k_p, k_idx = jax.random.split(k)
        return jax.random.uniform(k_p), jax.random.randint(k_idx, (), 0, POOL)
    u, idx = jax.jit(jax.vmap(one))(jax.random.split(key, n))
    return list(zip(np.asarray(u).tolist(), np.asarray(idx).tolist()))


def _jax_cyclegan(out_dir, batch):
    """The JAX CycleGAN, set up for the global `batch`."""
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    from ganslate_tpu.utils.testing import make_cyclegan_conf as jax_conf
    conf = jax_conf(str(out_dir), batch_size=GLOBAL, image_size=SIZE, channels=1,
                    n_residual_blocks=1, ngf=8, ndf=8, n_layers_D=1, pool_size=POOL,
                    mixed_precision=False, seed=3)
    model = jax_build_gan(conf)
    model.setup(example_batch=batch)
    return model


def _jax_pool_draws(model, steps):
    """The draws of the pools of the model's next `steps` steps (fake_B's,
    then fake_A's): each step splits its key into the next step's key and
    the pools' keys (`cyclegan.py`'s `jax.random.split(state.rng, 5)`)."""
    draws, rng = [], model.state.rng
    for _ in range(steps):
        rng, k_pool_B, k_pool_A, _, _ = jax.random.split(rng, 5)
        draws += [_pool_draws(k_pool_B, GLOBAL), _pool_draws(k_pool_A, GLOBAL)]
    return draws


def _jax_steps(model, batches):
    """JAX CycleGAN steps: the losses and parameters after each, and the
    gradients of step 1 (from Adam's first moment, (1 - beta1) g with
    beta1 = 1/2: an exact halving)."""
    losses, params, grads = [], [], {}
    for batch in batches:
        model.set_input(batch)
        model.optimize_parameters()
        losses.append({k: float(v) for k, v in jax.device_get(model.losses).items()})
        params.append(jax.device_get(model.state.params))
        if not grads:
            for group in ("G", "D"):
                mu = jax.device_get(model.state.opt_state[group].inner_state[0].mu)
                grads.update({name: jax.tree_util.tree_map(lambda m: 2 * np.asarray(m), tree)
                              for name, tree in mu.items()})
    return losses, params, grads


def _jax_batchnorm(x, cotangent, scale, bias):
    from ganslate_tpu.nn.layers import BatchNorm
    module = BatchNorm()

    def loss(params, x):
        return jnp.sum(module.apply({"params": params}, x) * cotangent)

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    y = jax.jit(module.apply)({"params": params}, x)
    dparams, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    return {k: np.asarray(v) for k, v in (("y", y), ("dx", dx), ("dscale", dparams["scale"]),
                                          ("dbias", dparams["bias"]))}


def _jax_pool(batches, keys):
    from ganslate_tpu.data.utils.image_pool import init_pool, query_pool
    pool = init_pool(POOL, batches[0].shape[1:])
    returned = []
    for images, key in zip(batches, keys):
        pool, out = jax.jit(query_pool)(pool, jnp.asarray(images), key)
        returned.append(np.asarray(out))
    return returned, np.asarray(pool.images), int(pool.count)


def _sliding_window_input(case):
    return np.random.default_rng(len(case[0])).normal(size=case[0]).astype(np.float32)


def _jax_sliding_window(x, case):
    from ganslate_tpu.utils.sliding_window_inferer import SlidingWindowInferer
    _, roi, sw_batch, overlap, scale = case
    inferer = SlidingWindowInferer(roi_size=roi, sw_batch_size=sw_batch, overlap=overlap,
                                   distributed=True)
    return np.asarray(inferer(jnp.asarray(x), lambda p, v: jnp.tanh(v * p["scale"]),
                              {"scale": jnp.float32(scale)}))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 2-rank launch, started as soon as its inputs are made; meanwhile
    the JAX references and the port's one-process CycleGAN steps at the
    global batch."""
    out = tmp_path_factory.mktemp("distributed")
    rng = np.random.default_rng(0)
    batches = [{k: rng.uniform(-1, 1, (GLOBAL, SIZE, SIZE, 1)).astype(np.float32)
                for k in ("A", "B")} for _ in range(2)]
    jax_model = _jax_cyclegan(out / "jax", batches[0])
    init = jax.device_get(jax_model.state.params)
    draws = _jax_pool_draws(jax_model, len(batches))
    one = child.cyclegan_model(out / "one", batches[0], draws=draws)
    for name in NETWORKS:
        load_flax_params(one.networks[name], init[name])
    state = {name: {k: v.clone() for k, v in one.networks[name].state_dict().items()}
             for name in NETWORKS}
    bn = {"x": rng.normal(1.5, 2.0, (GLOBAL, 6, 6, 4)).astype(np.float32),
          "cotangent": rng.normal(size=(GLOBAL, 6, 6, 4)).astype(np.float32),
          "scale": rng.uniform(0.5, 1.5, 4).astype(np.float32),
          "bias": rng.normal(size=4).astype(np.float32)}
    pool_batches = [rng.uniform(-1, 1, (GLOBAL, 6, 6, 1)).astype(np.float32)
                    for _ in range(2)]
    pool_keys = [jax.random.key(11), jax.random.key(12)]
    sw_inputs = {name: _sliding_window_input(case) for name, case in SW_CASES.items()}
    ranks = child.Ranks({
        "checks": ["cyclegan", "batchnorm", "pool", "verbs", "sliding_window"],
        "cyclegan": {"batches": batches, "state": state, "draws": draws},
        "batchnorm": bn,
        "pool": {"pool_size": POOL, "batches": pool_batches,
                 "draws": [_pool_draws(k, GLOBAL) for k in pool_keys]},
        "sliding_window": {name: {"x": x, "roi": SW_CASES[name][1],
                                  "sw_batch": SW_CASES[name][2], "overlap": SW_CASES[name][3],
                                  "scale": SW_CASES[name][4]}
                           for name, x in sw_inputs.items()}}, out / "ranks")

    jax_losses, jax_params, jax_grads = _jax_steps(jax_model, batches)
    one_rank = child.run_steps(one, batches)
    want = {"grads": jax_grads, "params": jax_params[0]}
    for key, tree in want.items():
        want[key] = {f"{name}.{k}": v.detach().clone() for name in NETWORKS
                     for k, v in load_flax_params(one.networks[name],
                                                  tree[name]).named_parameters()}
    return {"jax_losses": jax_losses, "jax_params": want["params"],
            "jax_grads": want["grads"], "one_rank": one_rank, "bn": bn,
            "jax_bn": _jax_batchnorm(**bn),
            "jax_pool": _jax_pool(pool_batches, pool_keys),
            "jax_sw": {name: _jax_sliding_window(x, SW_CASES[name])
                       for name, x in sw_inputs.items()},
            "ranks": ranks.results()}


def test_ranks_run_over_gloo(run):
    assert [r["backend"] for r in run["ranks"]] == ["gloo", "gloo"]


def test_two_rank_cyclegan_step_matches_jax(run):
    """Losses of both steps; the averaged gradients of step 1 within the
    one-process lockstep's 1e-4 relative L2; every parameter after step 1
    within its 1e-5, but for the components whose JAX gradient is below
    1e-6: Adam's first update, lr g / (|g| + 1e-8), takes the sign of such
    a component from rounding (one weight of G_BA's residual conv here,
    with a gradient of 1.5e-7, moves by 2 lr the other way in the
    one-process port too), and the rest of the run follows it."""
    got = run["ranks"][0]["cyclegan"]
    for step, (losses, want) in enumerate(zip(got["losses"], run["jax_losses"])):
        assert sorted(losses) == sorted(want)
        for k in want:
            np.testing.assert_allclose(losses[k], want[k], rtol=2e-4, atol=1e-5,
                                       err_msg=f"step {step + 1}, {k}")
    n_sign, n_total = 0, 0
    for k, want in run["jax_params"].items():
        grad = run["jax_grads"][k]
        if k in got["grads"]:
            rel = float((got["grads"][k] - grad).norm() / grad.norm())
            assert rel <= 1e-4, f"{k}: relative L2 {rel:.2e}"
        decided = (grad.abs() >= 1e-6) | (grad == 0)        # zero: the inert biases
        torch.testing.assert_close(got["params"][0][k][decided], want[decided], rtol=0,
                                   atol=1e-5, msg=k)
        n_sign += int((~decided).sum())
        n_total += want.numel()
    assert n_sign <= 1e-3 * n_total, (n_sign, n_total)


def test_two_ranks_match_one_rank_at_the_global_batch(run):
    got, want = run["ranks"][0]["cyclegan"], run["one_rank"]
    for losses, one in zip(got["losses"], want["losses"]):
        for k in one:
            np.testing.assert_allclose(losses[k], one[k], rtol=1e-6, err_msg=k)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, g in want["grads"].items():
        rel = float((got["grads"][k] - g).norm() / g.norm())
        assert rel <= 1e-6, f"{k}: relative L2 {rel:.2e}"


def test_ranks_hold_one_replica(run):
    """Averaged gradients, one pool and one generator state: the ranks'
    gradients and parameters are equal bit for bit."""
    first, second = (r["cyclegan"] for r in run["ranks"])
    for got, other in ((first["grads"], second["grads"]),
                       (first["params"][-1], second["params"][-1])):
        for k, v in got.items():
            assert torch.equal(v, other[k]), k


def test_batch_norm_statistics_span_the_ranks_as_jax(run):
    got = [r["batchnorm"] for r in run["ranks"]]
    want = run["jax_bn"]
    for k in ("y", "dx"):
        np.testing.assert_allclose(torch.cat([g[k] for g in got]).numpy(), want[k],
                                   rtol=0, atol=1e-6, err_msg=k)
    for k in ("dscale", "dbias"):
        np.testing.assert_allclose(sum(g[k] for g in got).numpy(), want[k], rtol=0,
                                   atol=1e-6 * np.abs(want[k]).max(), err_msg=k)


def test_batch_norm_outside_a_train_step_keeps_each_ranks_batch(run):
    """Outside `parallel.global_batch` (serving), each rank normalises its
    own share: the JAX BatchNorm on that share alone."""
    bn = run["bn"]
    for rank, got in enumerate(r["batchnorm"]["y_outside"] for r in run["ranks"]):
        share = slice(rank * GLOBAL // 2, (rank + 1) * GLOBAL // 2)
        want = _jax_batchnorm(bn["x"][share], bn["cotangent"][share], bn["scale"], bn["bias"])
        np.testing.assert_allclose(got.numpy(), want["y"], rtol=0, atol=1e-6)


def test_batch_norm_without_a_group_keeps_its_arithmetic():
    """No process group: no collective, the one-process expressions, in a
    train step's scope and outside it."""
    assert not communication.is_distributed()
    x = torch.randn(4, 3, 5, 5)
    bn = child.BatchNorm(3)
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    assert torch.equal(bn(x), (x - mean) * torch.rsqrt(var + 1e-5))
    with parallel.global_batch():
        assert not parallel.batch_spans_ranks()
        assert torch.equal(bn(x), (x - mean) * torch.rsqrt(var + 1e-5))


def test_pool_over_the_global_batch_equals_jax_exactly(run):
    got = [r["pool"] for r in run["ranks"]]
    returned, images, count = run["jax_pool"]
    for step, want in enumerate(returned):
        np.testing.assert_array_equal(torch.cat([g["returned"][step] for g in got]).numpy(),
                                      want)
    for g in got:
        np.testing.assert_array_equal(g["images"].numpy(), images)
        assert g["count"] == count == POOL


def test_verbs_keep_the_jax_semantics(run):
    """`communication`'s verbs give what the JAX package's document: each
    value's mean, summed or averaged over the ranks onto rank 0 (the others
    keep their own) or onto all; gathers in rank order, empty off `dst`;
    broadcast and the shared seed from rank 0 (or `src`)."""
    first, second = (r["verbs"] for r in run["ranks"])
    assert first["reduce_mean"] == 1.5 and second["reduce_mean"] == 2.0
    assert first["reduce_dict"] == second["reduce_dict"] == {"a": 3.0, "b": 3.0}
    assert list(first["reduce_dict"]) == ["a", "b"]
    assert first["reduce_list"] == [0.5, 2.0] and second["reduce_list"] == [1.0, 2.0]
    assert first["gather"] == [{"rank": 0}, {"rank": 1}] and second["gather"] == []
    assert first["gather_dst1"] == [] and second["gather_dst1"] == [0, 1]
    assert first["all_gather"] == second["all_gather"] == [("r", 0), ("r", 1)]
    assert first["broadcast"] == second["broadcast"] == "from 0"
    assert first["broadcast_src1"] == second["broadcast_src1"] == 10
    assert first["seed"] == second["seed"]
    np.random.seed(100)
    assert first["seed"] == np.random.randint(2 ** 31)
    assert first["world"] == second["world"] == first["device_count"] == 2
    assert (first["rank"], second["rank"]) == (0, 1)


def test_verbs_in_one_process_return_their_input():
    assert not communication.is_distributed()
    assert communication.reduce({"b": [1.0, 3.0], "a": 2.0}) == {"a": 2.0, "b": 2.0}
    assert communication.gather("x") == communication.all_gather("x") == ["x"]
    assert communication.broadcast(7) == 7
    assert communication.get_world_size() == communication.device_count() == 1
    communication.synchronize()
    communication.init_distributed()        # no WORLD_SIZE: no group
    assert not communication.is_distributed()


@pytest.mark.parametrize("name", SW_CASES)
def test_sliding_window_split_over_ranks_matches_jax(run, name):
    want = run["jax_sw"][name]
    got = [r["sliding_window"][name] for r in run["ranks"]]
    for g in got:
        np.testing.assert_allclose(g["y"].numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(got[0]["y"], got[1]["y"])
    # Each rank runs its half of the grid (the odd grid padded by one
    # window), per volume, in groups of the window batch.
    volume, roi, sw_batch = SW_CASES[name][:3]
    n = {"volume": 64, "images": 16, "odd-grid": 27}[name]
    for g in got:
        half = -(-n // 2)
        per_volume = [min(sw_batch, half - i) for i in range(0, half, sw_batch)]
        assert g["calls"] == per_volume * volume[0]


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("rank", [0, 1])
def test_loaders_take_the_jax_loaders_local_shares(tmp_path, monkeypatch, mode, rank):
    """At world size 2, rank `rank`'s loader yields what the JAX package's
    yields for that process, batch for batch: a global batch of 4 in
    shares of 2 from the shared sampler stream (train), and the strided
    in-order pass (val: 3 of the 6 pairs, a final short batch)."""
    from PIL import Image
    from ganslate_tpu.utils import communication as jax_communication
    from tests.test_torch_port_data_plane import _assert_same_batches, _loaders
    for module in (communication, jax_communication):
        monkeypatch.setattr(module, "get_rank", lambda: rank)
        monkeypatch.setattr(module, "get_world_size", lambda: 2)
        monkeypatch.setattr(module, "shared_random_seed", lambda: 123)
    rng = np.random.default_rng(4)
    for domain in "AB":
        (tmp_path / "paired" / domain).mkdir(parents=True)
        for i in range(6):
            Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(
                tmp_path / "paired" / domain / f"{i}.png")
    port, jax_loader = _loaders(tmp_path, "ganslate.data.PairedImageDataset", batch_size=4,
                                mode=mode)
    if mode == "train":
        got, want = ([b for _, b in zip(range(3), loader)] for loader in (port, jax_loader))
        assert [len(b["A"]) for b in got] == [2, 2, 2]
    else:
        got, want = list(port), list(jax_loader)
        assert [len(b["A"]) for b in got] == [2, 1]
    _assert_same_batches(got, want)


def test_backend_rule(monkeypatch):
    """nccl needs CUDA and a card per local rank; gloo otherwise."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert communication.pick_backend(cuda=True) == "nccl"
    assert communication.pick_backend(cuda=False) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert communication.pick_backend(cuda=True) == "gloo"
    assert communication.TIMEOUT <= datetime.timedelta(minutes=10)


def test_a_rank_takes_its_local_card_and_never_the_cpu(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert select_device(True) == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        select_device(True)


def test_a_global_batch_must_divide_over_the_ranks(monkeypatch):
    monkeypatch.setattr(communication, "get_world_size", lambda: 3)
    assert parallel.check_local_batch(6) == 2
    with pytest.raises(ValueError, match="does not divide over 3"):
        parallel.check_local_batch(8)
