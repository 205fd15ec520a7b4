"""The port's trainer (``genomad_torch.train``, ``igloo.apply_train``)
against the JAX package's on the CPU: the training forward, the loss and
every gradient against ``jax.value_and_grad``, AdamW against
``optax.adamw``, the parameter partition, the batches, the toy task, the
dropout masks, the data-parallel step in two gloo processes, and the
kernels' gradient guard. float32, tiny widths (``make_tiny_params``)."""

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genomad_torch import train as ttrain
from genomad_torch.models import igloo as tig
from genomad_torch.ops import _build
from genomad_tpu import train as jtrain
from genomad_tpu.models import igloo as jig
from tests.test_igloo import make_tiny_params
from tests.test_train import toy_data

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# the training forward against JAX's, f32
PROBS_TOL = dict(rtol=1e-5, atol=1e-6)
# gradients and parameters after a step: the tolerance of JAX's own
# test_sharded_train_step_matches_unsharded (tests/test_train.py)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
WORKER_TIMEOUT_S = 300


def _case(seed, n=6, L=64, V=9):
    rng = np.random.default_rng(seed)
    raw = make_tiny_params(rng, L=L, V=V)
    tokens = rng.integers(0, V, (n, L)).astype(np.int32)
    labels = (np.arange(n) % 3).astype(np.int32)
    return raw, tokens, labels


def _jax_value_and_grad(raw, tokens, labels):
    """JAX's loss around ``igloo.apply_train(..., dropout_rate=0.0)``."""
    trainable, static = jtrain.partition_params(jig.prepare_params(raw, compute_dtype=jnp.float32))

    def loss(t):
        probs = jig.apply_train(jtrain.merge_params(t, static), jnp.asarray(tokens), jax.random.PRNGKey(0), dropout_rate=0.0)
        log_probs = jnp.log(jnp.clip(probs, 1e-7, 1.0))
        return -jnp.mean(jnp.take_along_axis(log_probs, jnp.asarray(labels)[:, None], axis=1))

    return jax.value_and_grad(loss)(trainable)


def _state(raw, lr=1e-3):
    return ttrain.init_train_state(tig.params_from_numpy(raw, torch.float32), ttrain.make_optimizer(lr), device="cpu")


@pytest.mark.parametrize("seed, L", [(0, 64), (1, 64), (2, 96)])
def test_apply_train_probs_equal_jax(seed, L):
    raw, tokens, _ = _case(seed, L=L)
    ref = jig.apply_train(jig.prepare_params(raw, compute_dtype=jnp.float32), jnp.asarray(tokens), jax.random.PRNGKey(0), dropout_rate=0.0)
    got = tig.apply_train(tig.params_from_numpy(raw, torch.float32), torch.from_numpy(tokens), None, dropout_rate=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PROBS_TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_loss_and_every_gradient_equal_jax(seed):
    raw, tokens, labels = _case(seed)
    ref_loss, ref_grads = _jax_value_and_grad(raw, tokens, labels)
    state = _state(raw)
    loss = ttrain.loss_fn(state.trainable, state.static, torch.from_numpy(tokens), torch.from_numpy(labels), None, 0.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    assert ref_grads.keys() == state.trainable.keys()
    for group, leaves in ref_grads.items():
        assert leaves.keys() == state.trainable[group].keys(), group
        for name, g in leaves.items():
            got = state.trainable[group][name].grad
            np.testing.assert_allclose(got.numpy(), np.asarray(g), **GRAD_TOL, err_msg=f"{group}/{name}")


def test_three_adamw_steps_equal_optax():
    """The same gradients through optax.adamw and the port's AdamW."""
    raw, _, _ = _case(4)
    lr, wd = 3e-3, 1e-2
    trainable, _ = jtrain.partition_params(jig.prepare_params(raw, compute_dtype=jnp.float32))
    opt = optax.adamw(lr, weight_decay=wd)
    opt_state = opt.init(trainable)
    state = ttrain.init_train_state(tig.params_from_numpy(raw, torch.float32), ttrain.make_optimizer(lr, wd), device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), trainable)
        updates, opt_state = opt.update(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        for group, leaves in state.trainable.items():
            for name, p in leaves.items():
                p.grad = torch.from_numpy(np.asarray(grads[group][name]).copy())
        state.optimizer.step()
    got = ttrain.trainable_to_numpy(state.trainable)
    for group, leaves in trainable.items():
        for name, p in leaves.items():
            np.testing.assert_allclose(got[group][name], np.asarray(p), rtol=1e-6, atol=1e-7, err_msg=f"{group}/{name}")


def test_partition_keys_equal_jax_without_derived_keys():
    raw, _, _ = _case(0)
    j_train, j_static = jtrain.partition_params(jig.prepare_params(raw, compute_dtype=jnp.float32))
    t_train, t_static = ttrain.partition_params(tig.params_from_numpy(raw, torch.float32))
    keys = lambda tree: {(g, n) for g, sub in tree.items() if g not in ttrain._DERIVED_KEYS and sub for n in sub}  # noqa: E731
    assert keys(t_train) == keys(j_train)
    assert keys(t_static) == keys(j_static) == {("igloo1", "patches"), ("igloo2", "patches")}
    assert ttrain._DERIVED_KEYS == jtrain._DERIVED_KEYS
    assert all(p.requires_grad and p.is_leaf for sub in t_train.values() for p in sub.values())
    merged = ttrain.merge_params(t_train, t_static)
    assert merged.keys() == tig.params_from_numpy(raw, torch.float32).keys()


def test_trainable_round_trip_through_numpy():
    """A JAX TrainState's trainable leaves carried into the port and back."""
    raw, _, _ = _case(1)
    j_state = jtrain.init_train_state(jig.prepare_params(raw, compute_dtype=jnp.float32), jtrain.make_optimizer())
    tree = jax.tree_util.tree_map(np.asarray, j_state.trainable)
    t = ttrain.trainable_from_numpy(tree, device="cpu")
    assert all(p.requires_grad and p.is_leaf for sub in t.values() for p in sub.values())
    back = ttrain.trainable_to_numpy(t)
    for group, leaves in tree.items():
        for name, a in leaves.items():
            np.testing.assert_array_equal(back[group][name], a)


def test_make_batches_bit_equal_jax():
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 9, (37, 16)).astype(np.int32)
    labels = rng.integers(0, 3, 37).astype(np.int32)
    ref = list(jtrain.make_batches(tokens, labels, 8, seed=3))
    got = list(ttrain.make_batches(tokens, labels, 8, seed=3))
    assert len(got) == len(ref) == 4
    for (tg, lg), (tr, lr) in zip(got, ref):
        np.testing.assert_array_equal(tg, tr)
        np.testing.assert_array_equal(lg, lr)


def test_training_reduces_loss():
    """JAX's test_training_reduces_loss: the toy task at dropout 0.2."""
    rng = np.random.default_rng(0)
    state = _state(make_tiny_params(rng), lr=3e-3)
    step = ttrain.make_train_step(ttrain.make_optimizer(3e-3))
    tokens, labels = (torch.from_numpy(a) for a in toy_data(rng))
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(30):
        state, loss = step(state, tokens, labels, gen)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, losses
    assert state.step == 30


def test_train_step_checks_its_optimizer():
    """The step runs the optimizer bound in the state, and raises when that
    is not what the factory it was made with builds."""
    rng = np.random.default_rng(0)
    state = _state(make_tiny_params(rng), lr=1e-3)
    tokens, labels = (torch.from_numpy(a) for a in toy_data(rng))
    gen = torch.Generator().manual_seed(0)
    state, _ = ttrain.make_train_step(ttrain.make_optimizer(1e-3))(state, tokens, labels, gen)
    assert state.step == 1
    with pytest.raises(ValueError, match="not the one this step was made with"):
        ttrain.make_train_step(ttrain.make_optimizer(3e-3))(state, tokens, labels, gen)
    with pytest.raises(ValueError, match="not the one this step was made with"):
        ttrain.make_sharded_train_step(functools.partial(torch.optim.Adam, lr=1e-3))(state, tokens, labels, gen)
    assert state.step == 1


def test_dropout_masks_shape_scale_and_draw_order():
    raw, tokens, _ = _case(0, n=64)
    params = tig.params_from_numpy(raw, torch.float32)
    rate = 0.25
    masks = tig.dropout_masks(torch.Generator().manual_seed(7), params, 64, rate)
    assert [tuple(m.shape) for m in masks] == [(64, 1, 8)] * 3 + [(64, 12)]
    assert all(m.dtype == torch.bool for m in masks)
    kept = torch.cat([m.reshape(-1) for m in masks]).float().mean()
    assert abs(float(kept) - (1 - rate)) < 0.05
    # drawn in order from the generator: the same seed gives the same masks
    again = tig.dropout_masks(torch.Generator().manual_seed(7), params, 64, rate)
    assert all(torch.equal(a, b) for a, b in zip(masks, again))
    # SpatialDropout1D drops whole channels and scales the rest by 1/(1-r):
    # conv1's output under the masks equals the masked, scaled clean output
    t = torch.from_numpy(tokens)
    h1 = tig._leaky_relu(tig._causal_embed_conv(t, params["conv1"]["kernel"], params["conv1"]["bias"]))
    dropped = torch.where(masks[0], h1 / (1 - rate), torch.zeros_like(h1))
    assert torch.all(dropped[~masks[0].expand_as(h1)] == 0)
    torch.testing.assert_close(dropped[masks[0].expand_as(h1)], (h1 / (1 - rate))[masks[0].expand_as(h1)])
    # and the forward with the masks given equals the forward drawing them
    a = tig.apply_train(params, t, torch.Generator().manual_seed(7), rate)
    b = tig.apply_train(params, t, None, rate, masks=masks)
    assert torch.equal(a, b)
    assert not torch.allclose(a, tig.apply_train(params, t, None, 0.0))


def test_init_train_state_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    raw, _, _ = _case(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.init_train_state(tig.params_from_numpy(raw, torch.float32), ttrain.make_optimizer())


# ---------------------------------------------------------------------------
# The data-parallel step in two gloo processes
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(worker: str, out_dir: Path, world: int = 2) -> list:
    """Runs ``worker`` (a function of this test package, called with its
    output path) in ``world`` processes joined into one gloo group through
    the torchrun environment; each process has its own timeout. Returns
    the output paths by rank."""
    port = _free_port()
    module, fn = worker.rsplit(".", 1)
    procs, outs, logs = [], [], []
    for rank in range(world):
        env = os.environ.copy()
        env.pop("PYTHONPATH", None)
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
        out = out_dir / f"rank{rank}.npz"
        log = open(out_dir / f"rank{rank}.log", "w")
        code = f"import sys; sys.path.insert(0, {str(REPO)!r}); from {module} import {fn}; {fn}({str(out)!r})"
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO, stdout=log, stderr=log))
        outs.append(out)
        logs.append(log)
    try:
        for rank, p in enumerate(procs):
            rc = p.wait(timeout=WORKER_TIMEOUT_S)
            assert rc == 0, f"rank {rank} failed (rc={rc}):\n" + "\n".join(
                (out_dir / f"rank{i}.log").read_text()[-4000:] for i in range(world)
            )
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for log in logs:
            log.close()
    return outs


SHARDED_LR = 1e-3
SHARDED_RATE = 0.2


def _sharded_inputs():
    rng = np.random.default_rng(11)
    raw = make_tiny_params(rng)
    tokens, labels = toy_data(rng, n=16)
    return raw, torch.from_numpy(tokens), torch.from_numpy(labels)


def sharded_step_worker(out: str) -> None:
    """One rank of the two-process test: one sharded step, the trained
    leaves and the loss written to ``out``."""
    import torch.distributed as dist

    from genomad_torch.parallel import mesh

    torch.set_num_threads(1)
    assert mesh.initialize_distributed()
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
    raw, tokens, labels = _sharded_inputs()
    state = _state(raw, SHARDED_LR)
    step = ttrain.make_sharded_train_step(ttrain.make_optimizer(SHARDED_LR), dropout_rate=SHARDED_RATE)
    state, loss = step(state, tokens, labels, torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="does not divide"):
        step(state, tokens[:15], labels[:15], torch.Generator().manual_seed(1))
    leaves = ttrain.trainable_to_numpy(state.trainable)
    np.savez(out, loss=float(loss), **{f"{g}/{n}": a for g, sub in leaves.items() for n, a in sub.items()})
    dist.destroy_process_group()


def test_sharded_step_in_two_gloo_processes_equals_unsharded(tmp_path):
    outs = spawn_ranks("tests.test_torch_train.sharded_step_worker", tmp_path)
    raw, tokens, labels = _sharded_inputs()
    state = _state(raw, SHARDED_LR)
    step = ttrain.make_train_step(ttrain.make_optimizer(SHARDED_LR), dropout_rate=SHARDED_RATE)
    state, loss = step(state, tokens, labels, torch.Generator().manual_seed(1))
    want = ttrain.trainable_to_numpy(state.trainable)
    ranks = [np.load(o) for o in outs]
    for got in ranks:
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
        for group, sub in want.items():
            for name, a in sub.items():
                np.testing.assert_allclose(got[f"{group}/{name}"], a, **GRAD_TOL, err_msg=f"{group}/{name}")
    # every rank holds the same parameters after the step
    for key in ranks[0].files:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


# ---------------------------------------------------------------------------
# The kernels' gradient guard
# ---------------------------------------------------------------------------


def test_gradient_guard_raises_when_an_input_requires_grad():
    w = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("causal_conv", torch.zeros(3), w)
    with torch.no_grad():
        _build.refuse_grad("causal_conv", torch.zeros(3), w)
    with torch.inference_mode():
        _build.refuse_grad("causal_conv", torch.zeros(3), torch.zeros(3))
    _build.refuse_grad("causal_conv", torch.zeros(3), w.detach())


def test_gradient_guard_is_never_tripped_by_inference():
    """The classifier holds buffers (no leaf requires grad), so the guard
    passes on every kernel input of the inference path even with grad mode on."""
    rng = np.random.default_rng(0)
    model = tig.IglooClassifier(make_tiny_params(rng, V=257), device="cpu", dtype=torch.float32)
    tensors = list(model.buffers())
    assert tensors and not any(t.requires_grad for t in tensors)
    assert not any(True for _ in model.parameters())
    _build.refuse_grad("inference", *tensors)


# ---------------------------------------------------------------------------
# What the JAX package does with its derived keys after training
# ---------------------------------------------------------------------------


def test_jax_fine_tuned_params_keep_the_prepare_time_plans():
    """The JAX package's behaviour, recorded (ROADMAP queue 3), not a fault
    of the port: ``merge_params`` carries ``igloo1_plan`` / ``igloo2_plan``
    as ``prepare_params`` folded them, so after a step ``apply_bases`` (the
    Pallas branch, stale ``w_tiles``) and ``apply`` (the gather branch, the
    trained ``w_patch``) part; plans rebuilt from the trained weights
    agree again. The port's prepared dict has no derived leaves.
    ``-s`` prints the first output row of each."""
    from genomad_tpu.ops import patch_reduce as jpatch

    raw = jig.init_params(0)
    prep = jig.prepare_params(raw, compute_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    tokens = (1 + 85 * (np.arange(2) % 3)[:, None] + rng.integers(0, 85, (2, jig.WINDOW_TOKENS))).astype(np.int32)
    labels = (np.arange(2) % 3).astype(np.int32)
    opt = jtrain.make_optimizer(1e-2)
    state = jtrain.init_train_state(prep, opt)
    state, _ = jtrain.make_train_step(opt, donate=False)(state, jnp.asarray(tokens), jnp.asarray(labels), jax.random.PRNGKey(0))
    merged = jtrain.merge_params(state.trainable, state.static)
    for key in ("igloo1_plan", "igloo2_plan"):
        np.testing.assert_array_equal(np.asarray(merged[key]["w_tiles"]), np.asarray(prep[key]["w_tiles"]))
    bases = rng.integers(0, 4, (1, 6000)).astype(np.int32)
    tok = jig._tokens_from_bases(jnp.asarray(bases))[:, : jig.WINDOW_TOKENS]
    rows = {}
    for name, params in (("before", prep), ("after", merged)):
        rows[name] = (np.asarray(jig.apply(params, tok))[0], np.asarray(jig.apply_bases(params, jnp.asarray(bases)))[0])
    fresh = dict(merged)
    for g in ("igloo1", "igloo2"):
        plan = jpatch.build_plan(np.asarray(merged[g]["patches"]), np.asarray(merged[g]["w_patch"], np.float32), jig.L_PAD)
        fresh[g + "_plan"] = {"w_tiles": jnp.asarray(plan.w_tiles), "onehot": jnp.asarray(plan.onehot), "idx": jnp.asarray(plan.idx)}
    rebuilt = np.asarray(jig.apply_bases(fresh, jnp.asarray(bases)))[0]
    print("apply / apply_bases, row 0:", {k: (a.tolist(), b.tolist()) for k, (a, b) in rows.items()}, "rebuilt plans:", rebuilt.tolist())
    np.testing.assert_allclose(rows["before"][1], rows["before"][0], atol=1e-6)
    assert np.abs(rows["after"][1] - rows["after"][0]).max() > 0.05
    np.testing.assert_allclose(rebuilt, rows["after"][0], atol=1e-6)
