"""Port parity of SAM training (`sags_tpu_torch.models.sam_train` against
`sags_tpu.models.sam_train`) and of `semantics.domain_rand`: the training
examples, the loss and its gradients, three Adam steps against optax on the
same batches, the float16 weight files read across packages, and one draw
of the distortions. The JAX SAM is built once for the module. Each test
states its bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sags_tpu.io.datasets import SyntheticDataset as JaxSynthetic
from sags_tpu.models import sam_train as jax_train
from sags_tpu.models.sam import SAM as JaxSAM
from sags_tpu.semantics.domain_rand import domain_randomize as jax_domain_randomize
from sags_tpu_torch import interop
from sags_tpu_torch.io import datasets as tds
from sags_tpu_torch.models import sam as tsam
from sags_tpu_torch.models import sam_train
from sags_tpu_torch.semantics.domain_rand import domain_randomize

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py


@pytest.fixture(scope="module")
def jax_sam():
    return JaxSAM()


def port_sam(params) -> tsam.SAM:
    """The port's SAM on the CPU carrying the flax tree `params`."""
    sam = tsam.SAM(device="cpu")
    sd = interop.sam_params_from_numpy(jax.tree.map(np.asarray, params))
    sam.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return sam


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def random_batch(n=4, seed=0):
    """Canvas images, jittered boxes and 64×64 masks of the training shapes."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (n, 256, 256, 3)).astype(np.float32)
    lo = rng.uniform(0, 150, (n, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(20, 100, (n, 2))], -1).astype(np.float32)
    masks = (rng.uniform(0, 1, (n, 64, 64)) > 0.6).astype(np.float32)
    return imgs, boxes, masks


def test_make_training_data_matches_jax(monkeypatch):
    """One world, two frames. The port's dataset is given the JAX package's
    renders (the two rasterizers differ by up to 1e-3,
    `test_torch_pipeline.py::test_synthetic_dataset_matches_jax`), so this
    holds the canvas, boxes and masks. Bars: images to 1e-6, boxes exact,
    masks equal except on at most 0.1% of the pixels (the resizes' 0.5 ties)."""
    kw = dict(seeds=(0,), frames_per_world=2)
    want = jax_train.make_training_data(**kw)
    jds = JaxSynthetic(n_frames=2, width=160, height=120, seed=0, clutter=0.3)
    world = jds.world_xyz.tobytes()

    def same_world(ds):
        assert ds.world_xyz.tobytes() == world  # the same numpy stream
        return jds

    monkeypatch.setattr(tds.SyntheticDataset, "render_gt",
                        lambda self, i: same_world(self).render_gt(i))
    monkeypatch.setattr(tds.SyntheticDataset, "gt_objects",
                        lambda self, i: same_world(self).gt_objects(i))
    got = sam_train.make_training_data(device="cpu", **kw)
    assert len(got) == len(want) > 4
    off = 0
    for (gi, gb, gm), (wi, wb, wm) in zip(got, want):
        np.testing.assert_allclose(gi, wi, atol=1e-6)
        np.testing.assert_array_equal(gb, wb)
        off += int((gm != wm).sum())
    assert off <= 1e-3 * len(got) * 64 * 64, off


def key_bias(name: str) -> bool:
    """An attention key's bias: it adds q·b to every logit of a query's row,
    which softmax ignores, so its gradient is zero in exact arithmetic and
    rounding in either package."""
    return name.endswith(".key.bias")


def test_loss_and_gradients_match_jax(jax_sam):
    """BCE + dice of one batch from one set of parameters. Bars: the loss to
    1e-5 relative, each parameter's gradient to 1e-4 relative to its
    largest entry; the key biases' (`key_bias`) within 1e-4 of their key
    weights' largest gradient in both packages."""
    imgs, boxes, masks = random_batch()
    loss_j, grads_j = jax.value_and_grad(jax_train._loss_fn)(
        jax_sam.params, jax_sam, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(masks))
    sam = port_sam(jax_sam.params)
    names = [n for n, _ in sam.named_parameters()]
    with torch.enable_grad():
        loss_t = sam_train._loss_fn(sam, torch.as_tensor(imgs), torch.as_tensor(boxes),
                                    torch.as_tensor(masks))
        grads_t = torch.autograd.grad(loss_t, list(sam.parameters()))
    assert rel(float(loss_t.detach()), float(loss_j)) <= 1e-5
    want = interop.sam_params_from_numpy(jax.tree.map(np.asarray, grads_j))
    assert sorted(want) == sorted(names)
    got = {n: g.numpy() for n, g in zip(names, grads_t)}
    errs = {n: rel(got[n], want[n]) for n in names if not key_bias(n)}
    assert max(errs.values()) <= 1e-4, sorted(errs.items(), key=lambda x: -x[1])[:5]
    for n in filter(key_bias, names):
        scale = np.abs(want[n.replace(".bias", ".weight")]).max()
        assert max(np.abs(got[n]).max(), np.abs(want[n]).max()) <= 1e-4 * scale, n


def test_train_steps_match_optax(jax_sam):
    """Three steps of batch 4 from one set of parameters on the same eight
    examples: both draw `idx` and `bjit` from `default_rng(0)` in one order.
    Adam divides each gradient entry by its own magnitude, so an entry at
    the gradients' rounding level (1e-6 of the largest, see above) moves by
    up to lr a step in either direction. Bars, per parameter: its change over
    the three steps to 1e-3 relative in norm and every entry within 0.1·lr
    of the JAX package's (measured: 2.8e-4 and 0.084·lr). The key biases
    (`key_bias`), whose gradient is rounding, moved by at most 3·lr in
    both."""
    imgs, boxes, masks = random_batch(8, seed=1)
    data = list(zip(imgs, boxes, masks))
    start = jax_sam.params
    sam_t = port_sam(start)
    sam_j = JaxSAM()
    sam_j.params = start
    jax_train.train_sam(sam_j, data, steps=3, batch=4, log_every=0)
    losses = []
    sam_train.train_sam(sam_t, data, steps=3, batch=4, log_every=0, losses=losses)
    assert len(losses) == 3 and all(np.isfinite(float(x)) for x in losses)
    lr = 3e-4
    want = interop.sam_params_from_numpy(jax.tree.map(np.asarray, sam_j.params))
    p0 = interop.sam_params_from_numpy(jax.tree.map(np.asarray, start))
    for n, p in sam_t.named_parameters():
        p = p.detach().numpy().astype(np.float64)
        d_got, d_want = p - p0[n], want[n].astype(np.float64) - p0[n]
        if key_bias(n):
            assert max(np.abs(d_got).max(), np.abs(d_want).max()) <= 3 * lr * 1.001, n
            continue
        assert np.linalg.norm(d_got - d_want) <= 1e-3 * np.linalg.norm(d_want), n
        assert np.abs(d_got - d_want).max() <= 0.1 * lr, n


def test_save_fp16_is_read_by_both_packages(jax_sam, tmp_path):
    """The port's float16 file read by the JAX package's `load_pretrained`,
    and the JAX package's read by the port's: the float16-rounded
    parameters, bitwise."""
    sam_t = tsam.SAM(device="cpu", seed=3)
    port_file = str(tmp_path / "port.pkl")
    sam_train.save_fp16(sam_t, port_file)
    sam_j = JaxSAM()
    assert jax_train.load_pretrained(sam_j, port_file)
    got = interop.sam_params_from_numpy(jax.tree.map(np.asarray, sam_j.params))
    for n, p in sam_t.state_dict().items():
        np.testing.assert_array_equal(got[n], p.numpy().astype(np.float16).astype(np.float32),
                                      err_msg=n)

    jax_file = str(tmp_path / "jax.pkl")
    jax_train.save_fp16(jax_sam, jax_file)
    back = tsam.SAM(device="cpu")
    assert tsam.load_pretrained(back, jax_file)
    want = interop.sam_params_from_numpy(jax.tree.map(
        lambda x: np.asarray(x).astype(np.float16).astype(np.float32), jax_sam.params))
    for n, p in back.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), want[n], err_msg=n)


def test_sam_params_to_numpy_inverts_from_numpy(jax_sam):
    """The flax tree back from a state dict: the JAX package's tree, leaf
    for leaf, bitwise."""
    tree = jax.tree.map(np.asarray, jax_sam.params)
    back = interop.sam_params_to_numpy(interop.sam_params_from_numpy(tree))
    flat_want, tdef_want = jax.tree.flatten(tuple(tree))
    flat_got, tdef_got = jax.tree.flatten(tuple(back))
    assert tdef_got == tdef_want
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w)


def test_random_init_follows_flax_distributions(jax_sam):
    """`init_params`: the port's random SAM has each parameter's flax
    initialiser (not its values): per tensor, zero where flax's is zero, one
    where one, and otherwise a standard deviation within 4/√n of the JAX
    package's random SAM's (n entries; two samples' standard deviations
    differ by ~1/√n)."""
    ref = interop.sam_params_from_numpy(jax.tree.map(np.asarray, jax_sam.params))
    for n, p in tsam.SAM(device="cpu", seed=0).state_dict().items():
        p, w = p.numpy(), ref[n]
        if np.all(w == 0) or np.all(w == 1):
            np.testing.assert_array_equal(p, w, err_msg=n)
        else:
            assert abs(p.std() / w.std() - 1.0) < 4.0 / np.sqrt(p.size), (n, p.std(), w.std())


def test_domain_randomize_matches_jax():
    """One draw with the JPEG round trip on, from one seed: bitwise equal."""
    img = np.random.default_rng(0).uniform(0, 1, (3, 48, 64)).astype(np.float32)
    for seed in (0, 1):
        got = domain_randomize(img, np.random.default_rng(seed), strength=1.0, jpeg_prob=1.0)
        want = jax_domain_randomize(img, np.random.default_rng(seed), strength=1.0,
                                    jpeg_prob=1.0)
        np.testing.assert_array_equal(got, want)
