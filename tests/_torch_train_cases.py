"""Shared set-up of the sharded-training tests (tests/test_torch_sharded_
train*.py): the tiny preset's weights (every JAX leaf seeded noise, carried
over by `utils.from_flax`), batches whose rows differ in their valid
labels, the one-process reference (the worker's cases run without a mesh)
and the comparisons with their bounds.

Bound: fp32 on the CPU, the sharded step differing from the one-process
step only in the order of its sums (over ranks, over heads, over
micro-batches), so every loss and norm is held within a relative 1e-5 and
every trainable master and moment within 1e-5 of the tensor's scale (its
largest magnitude, at least ``FLOOR`` times the largest of its kind: a
gradient that the softmax's shift invariance makes zero, such as that of
a key bias, is rounding noise of about 1e-11 with no scale of its own);
frozen leaves are bit-identical.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mm_interleaved_tpu.configs import tiny_config as j_tiny
from mm_interleaved_tpu.models.mm_interleaved import MMInterleaved
from mm_interleaved_tpu_torch.utils.from_flax import convert_params

import _torch_train_worker as worker
from _torch_dist import run_ranks
from _torch_parity import interleaved_batch, noised

OPTIM = dict(warmup_steps=0, total_steps=10)
TOL = 1e-5
FLOOR = 1e-3
DROPOUT = 0.1
GATE = "mm_decoder.layers.0.llama_cross_attn.gate"


def tiny_state():
    """The port's state dict of the tiny preset with its image decoder:
    `_torch_eval_parity.tiny_pair`'s weights (the noise replaces every leaf
    of JAX's init, so the init's shapes are all it needs, traced without a
    compile)."""
    jcfg = j_tiny(with_image_decoder=True)
    batch = interleaved_batch(jcfg)
    keys = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "noise", "dropout"))}
    shapes = jax.eval_shape(lambda: MMInterleaved(jcfg).init(
        keys, **{k: jnp.asarray(v) for k, v in batch.items()}))
    params = noised(jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, x.dtype), shapes), seed=1)
    return convert_params(params["params"])


def unequal_batch(rows: int = 4, L: int = 40, seed: int = 0) -> dict:
    """``rows`` interleaved rows (of 0: two documents with an image each; 1:
    two images in one document; 2: text only, no image; 3: one image and a
    long text), each a different count of valid labels, image targets for
    the image decoder, padding at the end."""
    cfg = worker.tiny_config()
    S = cfg.special
    n_tok = cfg.num_img_token
    docs = [[[5, 6, "I", 7], [8, "I", 9, 10]],
            [[11, "I", 12, "I", 13, 14]],
            [[15, 16, 17]],
            [[18, "I"] + list(range(19, 30))]][:rows]

    def row(doc_list):
        r = []
        for doc in doc_list:
            r.append(S.bos_token_id)
            for x in doc:
                r += ([S.soi_token_id] + [S.image_token_id] * n_tok
                      if x == "I" else [x])
            r.append(S.eos_token_id)
        return r + [S.pad_token_id] * (L - len(r))

    rng = np.random.RandomState(seed)
    ids = np.array([row(d) for d in docs], np.int64)
    n_img = [sum(x == "I" for doc in d for x in doc) for d in docs]
    max_img = cfg.max_num_images
    size = cfg.visual.encoder.vit.image_size
    dec = cfg.image_decoder.image_size
    return dict(
        text_ids=torch.from_numpy(ids),
        image_tensors=torch.from_numpy(
            rng.rand(rows, max_img, size, size, 3).astype(np.float32)),
        num_image_per_seq=torch.tensor(n_img, dtype=torch.long),
        attention_mask=torch.from_numpy(
            (ids != S.pad_token_id).astype(np.int64)),
        image_tensors_dec=torch.from_numpy(
            rng.rand(rows, max_img, dec, dec, 3).astype(np.float32)))


def make_draws(rows: int, seed: int) -> dict:
    """Injected draws of the image decoder for ``rows`` rows (their image
    slots): VAE noise, noise, timesteps and uncond drops."""
    cfg = worker.tiny_config()
    idc = cfg.image_decoder
    n = rows * cfg.max_num_images
    g = torch.Generator().manual_seed(seed)
    shape = (n, idc.latent_size, idc.latent_size, idc.vae.latent_channels)
    return dict(vae_noise=torch.randn(shape, generator=g),
                noise=torch.randn(shape, generator=g),
                timesteps=torch.randint(
                    0, idc.schedule.num_train_timesteps, (n,), generator=g),
                uncond_drop=torch.rand((n,), generator=g) < 0.3)


def stacked(*batches) -> dict:
    """Micro-batches stacked on a leading axis."""
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def rows(batch: dict, order) -> dict:
    return {k: v[list(order)] for k, v in batch.items()}


def launch(job: dict, root, world: int, timeout: float = 150.0) -> dict:
    """The worker's cases as ``world`` gloo ranks; rank 0's results (and
    each rank's ``every_rank`` keys under ``"ranks"``)."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    path, out = os.path.join(root, "job.pt"), os.path.join(root, "out.pt")
    torch.save(job, path)
    run_ranks(["tests/_torch_train_worker.py", path, out], world=world,
              timeout=timeout)
    res = torch.load(out, weights_only=False)
    if job.get("every_rank"):
        res["ranks"] = [torch.load(f"{out}.rank{r}", weights_only=False)
                        for r in range(world)]
    return res


def one_process(job: dict, case: dict, scratch) -> dict:
    """The worker's case in this process, on one device (no mesh)."""
    return worker.run_case(job, case, None, str(scratch))


def close_scaled(got: torch.Tensor, want: torch.Tensor, what: str,
                 tol: float = TOL, floor: float = 0.0) -> None:
    """``got`` within ``tol`` of ``want``'s scale (its largest magnitude,
    at least ``floor``)."""
    err = float((got.double() - want.double()).abs().max()) \
        if want.numel() else 0.0
    scale = max(float(want.abs().max()) if want.numel() else 0.0, floor)
    assert err <= tol * scale, f"{what}: {err} over {tol} x {scale}"


def assert_metrics(got: dict, want: dict, rtol: float = TOL) -> None:
    assert set(got) == set(want), (got, want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def assert_payload(got: dict, want: dict, tol: float = TOL) -> None:
    """Every trainable master and both moments within ``tol`` of each
    tensor's scale; the same names and update count."""
    assert set(got["params"]) == set(want["params"])
    assert got["opt_state"]["count"] == want["opt_state"]["count"]
    for kind in ("params", "m", "v"):
        g = got[kind] if kind == "params" else got["opt_state"][kind]
        w = want[kind] if kind == "params" else want["opt_state"][kind]
        top = max(float(x.abs().max()) for x in w.values() if x.numel())
        for n, x in w.items():
            close_scaled(g[n], x, f"{kind} {n}", tol, FLOOR * top)


def assert_bitwise(got: dict, want: dict) -> None:
    """Masters, moments, count and step the same bits."""
    assert got["step"] == want["step"]
    assert got["opt_state"]["count"] == want["opt_state"]["count"]
    for n, x in want["params"].items():
        assert torch.equal(got["params"][n], x), n
        for k in ("m", "v"):
            assert torch.equal(got["opt_state"][k][n],
                               want["opt_state"][k][n]), (k, n)


def frozen_names(state: dict) -> list:
    tr = worker.trainer(dict(state=state, optim=OPTIM), {}, None)
    return [n for n, p in tr.model.named_parameters() if not p.requires_grad]


def assert_step(got: dict, want: dict, state: dict, frozen: list) -> None:
    """A sharded step against the one-process step: the metrics, every
    trainable master and moment (`assert_payload`), the frozen leaves
    bit-identical to the start, and the MMFS gate and a UNet leaf
    moved."""
    assert_metrics(got["metrics"], want["metrics"])
    assert_payload(got["payload"], want["payload"])
    for n in frozen:
        assert torch.equal(got["weights"][n], state[n]), n
    unet = next(n for n in got["payload"]["params"]
                if n.startswith("image_decoder.unet."))
    for n in (GATE, unet):
        assert not torch.equal(got["payload"]["params"][n], state[n]), n
