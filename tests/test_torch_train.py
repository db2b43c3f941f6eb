"""The port's trainer (async_ev_cnn_torch/models/train.py) held against the
JAX package's (async_ev_cnn_tpu/models/train.py) on the CPU: the YOLO loss,
the batch loss and every gradient, Adam steps, the optimizer state on disk
in both directions, and a resume within the port.

Tolerances, all float32:
* ``yolo_loss``: 1e-6 relative (the same arithmetic, sums in another order);
* the batch loss 1e-6 relative, each gradient within 1e-5 of that tensor's
  largest gradient magnitude (autograd and XLA sum the conv's weight and
  bias gradients in other orders);
* parameters after 5 Adam steps within 1e-6 absolute (the learning rate is
  1e-3: a thousandth of one step; torch.optim.Adam orders the update's
  arithmetic otherwise than optax), the step losses 1e-5 relative;
* an optimizer state read back from disk: bit for bit, in both directions;
* a resume within the port: parameters and moments bit for bit.
"""

from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from async_ev_cnn_torch.layers.network import EventNetwork as TNet
from async_ev_cnn_torch.models import train as ttrain
from async_ev_cnn_torch.utils import checkpoint as tck
from async_ev_cnn_torch.utils.weights import params_from_jax, params_to_jax
from async_ev_cnn_tpu.layers.network import EventNetwork as JNet
from async_ev_cnn_tpu.models import train as jtrain
from async_ev_cnn_tpu.utils import checkpoint as jck
from async_ev_cnn_tpu.utils.config import layers_dict

torch.set_num_threads(2)

LOSS_RTOL = 1e-6
GRAD_REL = 1e-5
STEP_ATOL = 1e-6
STEP_LOSS_RTOL = 1e-5
H = W = 16
SH = SW = 4
NUM_CLASSES, NUM_BBOX = 3, 2
OUT_C = NUM_CLASSES + NUM_BBOX * 5
CONV_LAYERS = f"conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,16 pool2=2,2 conv3=1,1,16,{OUT_C}"
# the same conv stack with an fc tail that maps the flattened 4x4x13 map
# onto the grid
FC_LAYERS = (f"conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,16 pool2=2,2 conv3=1,1,16,8 "
             f"flatten1= fc1=128,{SH * SW * OUT_C}")
TAILS = {"conv": CONV_LAYERS, "fc": FC_LAYERS}


def make_params(rng, layers, bias_scale=0.0):
    """Seeded checkpoint-convention weights (HWIO); zero biases unless
    ``bias_scale``."""
    params = {}
    for name, size in layers.items():
        if "conv" in name or "fc" in name:
            params[f"w_{name}"] = (rng.randn(*size) * 0.2).astype(np.float32)
            params[f"b_{name}"] = (rng.randn(size[-1]) * bias_scale).astype(np.float32)
    return params


def toy_batch(rng, n):
    """Frames ``[n, 16, 16]`` whose lower half is zero (exact zeros through
    the first conv where its taps see no event) and grid targets with one
    to a few objects each."""
    frames = rng.rand(n, H, W).astype(np.float32)
    frames[:, H // 2:] = 0.0
    boxes = rng.rand(n, SH, SW, 4).astype(np.float32)
    obj = (rng.rand(n, SH, SW) > 0.7).astype(np.float32)
    obj[:, 0, 0] = 1.0
    cls = rng.randint(0, NUM_CLASSES, (n, SH, SW)).astype(np.int32)
    return frames, (boxes, obj, cls)


def nets(layers):
    return (JNet(layers, H, W, leak=1e-4, alpha=0.1, padding="SAME"),
            TNet(layers, H, W, 1e-4, 0.1, "SAME"))


def trainers(layers, lr=1e-3):
    jn, tn = nets(layers)
    return (jtrain.Trainer(jn, NUM_CLASSES, NUM_BBOX, (SH, SW), optimizer=optax.adam(lr)),
            ttrain.Trainer(tn, NUM_CLASSES, NUM_BBOX, (SH, SW), learning_rate=lr))


def jax_targets(t):
    return jtrain.YoloTargets(*(jnp.asarray(a) for a in t))


def torch_targets(t):
    return ttrain.YoloTargets(*(torch.from_numpy(a) for a in t))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _grids(rng, case):
    """Grids ``[4, S, S, C + B*5]`` and targets for a loss case."""
    n = 4
    grid = rng.randn(n, SH, SW, OUT_C).astype(np.float32)
    _, targets = toy_batch(rng, n)
    if case == "tied confidences":  # every cell's B confidences equal
        conf = grid[..., NUM_CLASSES + 4::5]
        grid[..., NUM_CLASSES + 4::5] = conf[..., :1]
    elif case == "zero grid":
        grid[:] = 0.0
    elif case == "class out of range":  # one_hot of it is all zeros in JAX
        targets[2][:, 0, 0] = NUM_CLASSES
    return grid, targets


@pytest.mark.parametrize("case", ["random", "tied confidences", "zero grid",
                                  "class out of range"])
def test_yolo_loss_matches_jax(rng, case):
    grid, targets = _grids(rng, case)
    want = [float(jtrain.yolo_loss(jnp.asarray(grid[i]),
                                   jtrain.YoloTargets(*(jnp.asarray(a[i]) for a in targets)),
                                   NUM_CLASSES, NUM_BBOX)) for i in range(grid.shape[0])]
    batched = ttrain.yolo_loss(torch.from_numpy(grid), torch_targets(targets),
                               NUM_CLASSES, NUM_BBOX)
    assert batched.shape == (grid.shape[0],)
    for i, w in enumerate(want):
        one = ttrain.yolo_loss(torch.from_numpy(grid[i]),
                               ttrain.YoloTargets(*(torch.from_numpy(a[i]) for a in targets)),
                               NUM_CLASSES, NUM_BBOX)
        assert one.shape == ()
        np.testing.assert_allclose(float(one), w, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(batched[i]), w, rtol=LOSS_RTOL)


def test_yolo_loss_perfect_prediction_is_small():
    """The JAX package's perfect-prediction case, in the port."""
    boxes = np.zeros((SH, SW, 4), np.float32)
    obj = np.zeros((SH, SW), np.float32)
    cls = np.zeros((SH, SW), np.int32)
    obj[1, 2] = 1
    boxes[1, 2] = [0.3, 0.7, 0.16, 0.04]
    cls[1, 2] = 2
    grid = np.zeros((SH, SW, OUT_C), np.float32)
    grid[1, 2, :3] = [0, 0, 1]
    grid[1, 2, 3:8] = [0.3, 0.7, 0.4, 0.2, 1.0]  # box 0 perfect, conf 1
    loss = ttrain.yolo_loss(torch.from_numpy(grid), torch_targets((boxes, obj, cls)),
                            NUM_CLASSES, NUM_BBOX)
    assert float(loss) < 1e-6


def test_yolo_loss_responsible_box_carries_no_gradient():
    """Tied confidences pick box 0 (the first maximum, as jnp.argmax), and
    the selection is a constant: the confidences' gradient is JAX's."""
    grid = np.zeros((SH, SW, OUT_C), np.float32)
    grid[..., NUM_CLASSES + 4::5] = 0.5
    targets = (np.zeros((SH, SW, 4), np.float32), np.ones((SH, SW), np.float32),
               np.zeros((SH, SW), np.int32))
    want = jax.grad(lambda g: jtrain.yolo_loss(
        g, jtrain.YoloTargets(*(jnp.asarray(a) for a in targets)),
        NUM_CLASSES, NUM_BBOX))(jnp.asarray(grid))
    g = torch.from_numpy(grid).requires_grad_(True)
    ttrain.yolo_loss(g, torch_targets(targets), NUM_CLASSES, NUM_BBOX).backward()
    np.testing.assert_array_equal(g.grad.numpy(), np.asarray(want))
    # box 0 owns every cell: its confidence is pulled to 1, box 1's to 0
    assert (g.grad.numpy()[..., NUM_CLASSES + 4] < 0).all()
    assert (g.grad.numpy()[..., NUM_CLASSES + 9] > 0).all()


@pytest.mark.parametrize("tail", sorted(TAILS))
def test_batch_loss_and_gradients_match_jax(rng, tail):
    """One batch through the JAX Trainer's ``_batch_loss`` under
    ``jax.value_and_grad`` and through the port's under autograd, from zero
    biases on frames with zero regions (pre-activations exactly 0, pool
    windows all equal: the ties of leaky's max and of the pool)."""
    layers = layers_dict(TAILS[tail])
    params = make_params(rng, layers)
    frames, targets = toy_batch(rng, 6)
    jt, tt = trainers(layers)
    want_loss, want_grads = jax.value_and_grad(jt._batch_loss)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(frames),
        jax_targets(targets))
    tp = params_from_jax(params, "cpu")
    tt.init(tp)
    loss = tt._batch_loss(tp, torch.from_numpy(frames), torch_targets(targets))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    grads = params_to_jax({k: v.grad for k, v in tp.items()})
    assert sorted(grads) == sorted(want_grads)
    for k, w in want_grads.items():
        w = np.asarray(w)
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(grads[k], w, rtol=0, atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("tail", sorted(TAILS))
def test_five_steps_match_jax(rng, tail):
    layers = layers_dict(TAILS[tail])
    params = make_params(rng, layers, bias_scale=0.05)
    frames, targets = toy_batch(rng, 8)
    jt, tt = trainers(layers)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = jt.init(jp)
    tp = params_from_jax(params, "cpu")
    topt = tt.init(tp)
    f_t, t_t = torch.from_numpy(frames), torch_targets(targets)
    for _ in range(5):
        jp, jopt, jloss = jt.step(jp, jopt, jnp.asarray(frames), jax_targets(targets))
        tp, topt, tloss = tt.step(tp, topt, f_t, t_t)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=STEP_LOSS_RTOL)
    got = params_to_jax(tp)
    for k in jp:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=0, atol=STEP_ATOL,
                                   err_msg=k)
        assert not np.array_equal(got[k], params[k]), k  # every tensor moved


def learnable_batch(rng, n):
    """The JAX package's toy task (tests/test_train.py): one object a frame
    whose cell and class depend on the frame's content."""
    frames = rng.rand(n, H, W).astype(np.float32)
    boxes = np.zeros((n, SH, SW, 4), np.float32)
    obj = np.zeros((n, SH, SW), np.float32)
    cls = np.zeros((n, SH, SW), np.int32)
    for i in range(n):
        cy, cx = int(frames[i, :4, :4].sum() * 7) % SH, i % SW
        obj[i, cy, cx] = 1
        boxes[i, cy, cx] = [0.5, 0.5, 0.25, 0.25]
        cls[i, cy, cx] = i % 3
        frames[i, cy * 4: cy * 4 + 4, cx * 4: cx * 4 + 4] += 1.0
    return frames, (boxes, obj, cls)


def test_training_reduces_loss(rng):
    """The JAX package's toy task (40 steps on a fixed batch), in the port."""
    layers = layers_dict(CONV_LAYERS)
    params = params_from_jax(make_params(rng, layers, bias_scale=0.05), "cpu")
    _, tt = trainers(layers)
    opt = tt.init(params)
    frames, targets = learnable_batch(rng, 8)
    f_t, t_t = torch.from_numpy(frames), torch_targets(targets)
    losses = []
    for _ in range(40):
        params, opt, loss = tt.step(params, opt, f_t, t_t)
        losses.append(float(loss))
    assert losses[-1] < 0.3 * losses[0], losses[::10]


def _after_steps(rng, layers, k):
    """``(params, jax params, jax opt state, port params, port optimizer)``
    after ``k`` steps of each package from the same start."""
    params = make_params(rng, layers, bias_scale=0.05)
    frames, targets = toy_batch(rng, 4)
    jt, tt = trainers(layers)
    jp = {kk: jnp.asarray(v) for kk, v in params.items()}
    jopt = jt.init(jp)
    tp = params_from_jax(params, "cpu")
    topt = tt.init(tp)
    for _ in range(k):
        jp, jopt, _ = jt.step(jp, jopt, jnp.asarray(frames), jax_targets(targets))
        tp, topt, _ = tt.step(tp, topt, torch.from_numpy(frames), torch_targets(targets))
    return params, jp, jopt, tp, topt


def _port_moments(tp, topt, which):
    """The port optimizer's ``exp_avg`` or ``exp_avg_sq`` in the checkpoint
    layout (zeros before its first step)."""
    return params_to_jax({k: topt.state[p][which] if p in topt.state else torch.zeros_like(p)
                          for k, p in tp.items()})


@pytest.mark.parametrize("steps", [0, 3])
def test_opt_state_written_by_jax_reads_in_the_port(tmp_path, rng, steps):
    """``save_stream_state(optax.adam(...) state)`` (the JAX CLI's
    ``.opt.npz``) restored into a fresh port optimizer: count and moments
    bit for bit after the HWIO -> OIHW transposes."""
    layers = layers_dict(FC_LAYERS)
    params, _, jopt, _, _ = _after_steps(rng, layers, steps)
    path = str(tmp_path / "j.opt.npz")
    jck.save_stream_state(path, jopt)
    tp = params_from_jax(params, "cpu")
    _, tt = trainers(layers)
    topt = tt.init(tp)
    ttrain.restore_adam_state(path, tp, topt)
    adam = jopt[0]
    assert int(adam.count) == steps
    assert all(float(topt.state[p]["step"]) == steps for p in tp.values())
    for which, want in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got = _port_moments(tp, topt, which)
        assert sorted(got) == sorted(want)
        for k in want:
            assert topt.state[tp[k]][which].shape == tp[k].shape
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


@pytest.mark.parametrize("steps", [0, 3])
def test_opt_state_written_by_the_port_reads_in_jax(tmp_path, rng, steps):
    """The port's ``.opt.npz`` restored by the JAX package into
    ``optax.adam(...).init(params)``'s structure: the int32 count and the
    moments (HWIO) bit for bit."""
    layers = layers_dict(FC_LAYERS)
    params, _, _, tp, topt = _after_steps(rng, layers, steps)
    path = str(tmp_path / "t.opt.npz")
    ttrain.save_adam_state(path, tp, topt)
    like = optax.adam(1e-3).init({k: jnp.asarray(v) for k, v in params.items()})
    back = jck.restore_stream_state(path, like=like)
    assert len(jax.tree.leaves(back)) == 1 + 2 * len(params)
    adam = back[0]
    assert adam.count.dtype == jnp.int32 and int(adam.count) == steps
    for which, got in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = _port_moments(tp, topt, which)
        for k in params:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def test_port_resume_is_bit_for_bit(tmp_path, rng):
    """8 steps == 4 steps, the weights (.npz) and optimizer state
    (.opt.npz) on disk, a fresh Trainer from them, 4 more steps: parameters
    and moments bit for bit.  Restarting the moments instead diverges."""
    layers = layers_dict(FC_LAYERS)
    start = make_params(rng, layers, bias_scale=0.05)
    frames, targets = toy_batch(rng, 4)
    f_t, t_t = torch.from_numpy(frames), torch_targets(targets)

    def run(params, opt, tt, k):
        for _ in range(k):
            params, opt, _ = tt.step(params, opt, f_t, t_t)
        return params, opt

    _, tt = trainers(layers)
    full = params_from_jax(start, "cpu")
    full, full_opt = run(full, tt.init(full), tt, 8)

    mid = params_from_jax(start, "cpu")
    mid, mid_opt = run(mid, tt.init(mid), tt, 4)
    tck.save_params(str(tmp_path / "mid.npz"), params_to_jax(mid))
    ttrain.save_adam_state(str(tmp_path / "mid.opt.npz"), mid, mid_opt)

    def resumed(with_moments):
        _, tt2 = trainers(layers)
        p = params_from_jax(tck.load_params(str(tmp_path / "mid.npz")), "cpu")
        opt = tt2.init(p)
        if with_moments:
            ttrain.restore_adam_state(str(tmp_path / "mid.opt.npz"), p, opt)
        return run(p, opt, tt2, 4)

    res, res_opt = resumed(True)
    for k in full:
        np.testing.assert_array_equal(_bits(params_to_jax(res)[k]),
                                      _bits(params_to_jax(full)[k]), err_msg=k)
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(res_opt.state[res[k]][m], full_opt.state[full[k]][m]), (k, m)
        assert float(res_opt.state[res[k]]["step"]) == 8
    cold, _ = resumed(False)
    assert any(not torch.equal(cold[k], full[k]) for k in full)


def test_trainer_refuses_a_mesh():
    """A mesh without a 'data' axis is refused; on a 1 x 1 mesh (a world
    of 1, gloo on the CPU) a step is the unsharded step bit for bit (tests/
    test_torch_parallel.py holds the data-parallel step on 4 ranks)."""
    from async_ev_cnn_torch.parallel import make_mesh, make_time_mesh, world

    _, tt = trainers(layers_dict(CONV_LAYERS))
    rng = np.random.RandomState(3)
    frames = torch.from_numpy(rng.rand(4, H, W).astype(np.float32))
    targets = ttrain.YoloTargets(torch.rand(4, SH, SW, 4), torch.ones(4, SH, SW),
                                 torch.zeros(4, SH, SW, dtype=torch.int64))
    with world("cpu"):
        with pytest.raises(ValueError, match="needs a 'data' axis"):
            ttrain.Trainer(tt.net, NUM_CLASSES, NUM_BBOX, (SH, SW),
                           mesh=make_time_mesh(device="cpu"))
        mesh = make_mesh(1, 1, device="cpu")
        runs = []
        for m in (mesh, None):
            trainer = ttrain.Trainer(tt.net, NUM_CLASSES, NUM_BBOX, (SH, SW), mesh=m)
            params = params_from_jax(make_params(np.random.RandomState(4),
                                                 layers_dict(CONV_LAYERS), 0.1), "cpu")
            params, _, loss = trainer.step(params, trainer.init(params), frames, targets)
            runs.append((loss, params))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[1][1])


def test_tree_leaves_walk_dicts_in_sorted_key_order(tmp_path):
    """``save_stream_state``/``restore_stream_state`` take dicts as
    ``jax.tree.leaves`` does (a dict's keys sorted whatever the insertion
    order, an OrderedDict's in insertion order), so a tree of dicts crosses
    the packages in both directions."""
    rng = np.random.RandomState(3)
    tree = (np.int32(5),
            {"w_b": rng.rand(2, 3).astype(np.float32), "a": rng.rand(4).astype(np.float32)},
            OrderedDict([("z", (rng.rand(1).astype(np.float32),)),
                         ("b", rng.rand(2).astype(np.float32))]))
    want = [np.asarray(a) for a in jax.tree.leaves(tree)]
    got = [np.asarray(a) for a in tck._leaves(tree)]
    assert len(got) == len(want) == 5
    assert got[1].shape == (4,) and got[3].shape == (1,)  # "a" before "w_b"; "z" first
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jlike = jax.tree.map(jnp.asarray, tree)
    tlike = jax.tree.map(torch.from_numpy, jax.tree.map(np.asarray, tree))
    tck.save_stream_state(str(tmp_path / "t.npz"), tlike)
    jck.save_stream_state(str(tmp_path / "j.npz"), jlike)
    from_port = jck.restore_stream_state(str(tmp_path / "t.npz"), like=jlike)
    from_jax = tck.restore_stream_state(str(tmp_path / "j.npz"), like=tlike)
    assert list(from_jax[1]) == list(tlike[1])  # the structure's own key order
    for a, b in zip(jax.tree.leaves(from_port), tck._leaves(from_jax)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_params_to_jax_inverts_params_from_jax(rng):
    layers = layers_dict(FC_LAYERS)
    params = make_params(rng, layers, bias_scale=0.05)
    tp = params_from_jax(params, "cpu")
    assert tp["w_conv1"].shape == (8, 1, 3, 3)
    back = params_to_jax(tp)
    assert sorted(back) == sorted(params)
    for k in params:
        assert back[k].flags.c_contiguous
        np.testing.assert_array_equal(_bits(back[k]), _bits(params[k]), err_msg=k)


def test_save_params_refuses_tensors(tmp_path):
    """A port tensor (OIHW) is refused, not written in the wrong layout."""
    with pytest.raises(TypeError, match="params_to_jax"):
        tck.save_params(str(tmp_path / "w.npz"), {"w_conv1": torch.zeros(4, 1, 3, 3)})
    with pytest.raises(TypeError, match="params_to_jax"):
        tck.save_params_tf(str(tmp_path / "w"), {"w_conv1": torch.zeros(4, 1, 3, 3)})
