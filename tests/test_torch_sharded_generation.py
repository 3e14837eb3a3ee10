"""The port's sharded runtime (`parallel.inference.ShardedGenerator`) on
gloo CPU processes against the JAX package's `LocalGenerator` and the
port's own.

The JAX package's tests/test_sharded_generation.py holds JAX's
`ShardedGenerator` to its `LocalGenerator`; here the port's sharded
runtime is held to JAX's `LocalGenerator` (greedy, K = 2 beam and int8
tokens) and to the port's `LocalGenerator` on the same weights (the tiny
preset with its image decoder, every JAX leaf seeded noise, carried over
by `utils.from_flax` into a temporary file the ranks load).  Meshes
``(data, fsdp, tensor)``: (1, 1, 2), (1, 2, 1), (2, 1, 1), (1, 2, 2), one
process a rank (`_torch_sharded_worker.py`, which imports no JAX), each
group run once and killed at its timeout.  Checked on each mesh:

  * greedy tokens equal to JAX's and to the local run's; a K = 2 beam
    likewise; sampled tokens equal to the local run's under the same
    generator (the uniforms drawn at the global batch);
  * images within 1e-4 of the local run's, with latents and noises
    injected and with both drawn from one generator; the image inputs
    within 1e-5; option scores within 1e-5;
  * int8 greedy tokens equal to JAX's int8 `LocalGenerator`'s and the
    local int8 run's, every code and scale equal to the whole layer's
    quantized whole, then cut (every rank);
  * a rank's KV cache holds ``n_kv / tensor`` heads and ``B / (data *
    fsdp)`` rows; a 3-row batch, which ``data * fsdp = 2`` does not
    divide, runs replicated and equals the local run;
  * the towers and the vocabulary are cut: a rank's ViT, adapter,
    Q-Former, UNet, MMFSNet, embedding and text-head rows are ``1 /
    tensor`` of the whole model's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.generation.text import TextGenerationConfig as JGenCfg
from mm_interleaved_tpu.parallel.inference import LocalGenerator as JLocal
from mm_interleaved_tpu_torch.parallel.inference import LocalGenerator
from mm_interleaved_tpu_torch.utils.from_flax import convert_params

import _torch_sharded_worker as worker
from _torch_dist import run_ranks
from _torch_eval_parity import tiny_pair

MESHES = [(1, 1, 2), (1, 2, 1), (2, 1, 1), (1, 2, 2)]
NEW = 5
STEPS = 2
SEED = 1234


def _batch(cfg, B: int, L: int = 16, seed: int = 0):
    """``B`` left-padded rows with one image each (the JAX package's
    tests/test_sharded_generation.py prompt), a different token a row."""
    S = cfg.special
    rng = np.random.RandomState(seed)
    row = [S.bos_token_id, 5, S.soi_token_id] + \
        [S.image_token_id] * cfg.num_img_token + [7, 8]
    pad = L - len(row)
    ids = np.tile(np.asarray([S.pad_token_id] * pad + row, np.int64), (B, 1))
    ids[:, pad + 1] = 9 + np.arange(B)
    ids[1, :pad + 1] = S.pad_token_id  # one row shorter
    size = cfg.visual.encoder.vit.image_size
    return dict(
        text_ids=torch.from_numpy(ids),
        image_tensors=torch.from_numpy(rng.rand(
            B, cfg.max_num_images, size, size, 3).astype(np.float32)),
        num_image_per_seq=torch.ones(B, dtype=torch.long),
        attention_mask=torch.from_numpy((ids != S.pad_token_id)
                                        .astype(np.int64)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, jmodel, params, model = tiny_pair(with_image_decoder=True)
    cfg = model.cfg
    x = _batch(cfg, 4)
    rs = np.random.RandomState(5)
    idc = cfg.image_decoder
    shape = (4, idc.latent_size, idc.latent_size, idc.vae.latent_channels)
    job = dict(
        state=convert_params(params["params"]), inputs=x, new_tokens=NEW,
        seed=SEED, steps=STEPS,
        targets=torch.arange(4) * cfg.max_num_images,
        latents=torch.from_numpy(rs.randn(*shape).astype(np.float32)),
        noises=torch.from_numpy(rs.randn(STEPS, *shape).astype(np.float32)),
        options_ids=torch.from_numpy(rs.randint(3, 100, (4, 3, 5))),
        options_mask=torch.from_numpy(
            np.concatenate([np.ones((4, 3, 1)), rs.rand(4, 3, 4) > 0.3],
                           axis=2).astype(np.int64)),
        odd=_batch(cfg, 3, seed=1))
    root = tmp_path_factory.mktemp("sharded")
    torch.save(job, root / "job.pt")
    local = worker.run(LocalGenerator(model), job)
    qmodel = worker.tiny_model(job["state"])
    local["int8_greedy"] = LocalGenerator(qmodel, quantize="int8") \
        .generate_texts(x["text_ids"], x["image_tensors"],
                        x["num_image_per_seq"], x["attention_mask"],
                        cfg=worker.gen_cfgs(cfg.special, NEW)["greedy"])
    jax_tokens = {}
    s = jcfg.special
    for name, beams, quantize in (("greedy", 1, None), ("beam", 2, None),
                                  ("int8_greedy", 1, "int8")):
        jgen = JLocal(jmodel, params, quantize=quantize)
        jax_tokens[name] = np.asarray(jgen.generate_texts(
            *(jnp.asarray(x[k].numpy()) for k in (
                "text_ids", "image_tensors", "num_image_per_seq",
                "attention_mask")),
            JGenCfg(max_new_tokens=NEW, num_beams=beams,
                    pad_token_id=s.pad_token_id,
                    eos_token_ids=(s.eos_token_id, s.soi_token_id))))
    return dict(root=root, job=job, local=local, jax=jax_tokens, cfg=cfg)


@pytest.fixture(scope="module", params=MESHES,
                ids=lambda m: "mesh_%d_%d_%d" % m)
def sharded(request, setup):
    mesh = request.param
    root = setup["root"]
    job = dict(setup["job"], mesh=mesh)
    path = root / ("job_%d_%d_%d.pt" % mesh)
    out = root / ("out_%d_%d_%d.pt" % mesh)
    torch.save(job, path)
    run_ranks(["tests/_torch_sharded_worker.py", str(path), str(out)],
              world=int(np.prod(mesh)), timeout=180)
    return mesh, torch.load(out, weights_only=False)


def test_greedy_tokens_equal_jax_and_local(setup, sharded):
    _, got = sharded
    np.testing.assert_array_equal(got["greedy"].numpy(),
                                  setup["local"]["greedy"].numpy())
    np.testing.assert_array_equal(got["greedy"].numpy(),
                                  setup["jax"]["greedy"])


def test_beam_tokens_equal_jax_and_local(setup, sharded):
    _, got = sharded
    np.testing.assert_array_equal(got["beam"].numpy(),
                                  setup["local"]["beam"].numpy())
    np.testing.assert_array_equal(got["beam"].numpy(), setup["jax"]["beam"])


def test_sampled_tokens_equal_local(setup, sharded):
    _, got = sharded
    assert torch.equal(got["sampled"], setup["local"]["sampled"])


def test_images_and_inputs_within_tolerance_of_local(setup, sharded):
    _, got = sharded
    local = setup["local"]
    for a, b in zip(got["image_inputs"], local["image_inputs"]):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=0, atol=1e-5)
    for key in ("images", "images_drawn"):
        assert got[key].shape == local[key].shape
        np.testing.assert_allclose(got[key].numpy(), local[key].numpy(),
                                   rtol=0, atol=1e-4)


def test_scores_within_1e5_of_local(setup, sharded):
    _, got = sharded
    assert got["scores"].shape == (4, 3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               setup["local"]["scores"].numpy(), rtol=0,
                               atol=1e-5)


def test_int8_tokens_equal_jax_and_local_and_codes_equal(setup, sharded):
    _, got = sharded
    assert torch.equal(got["int8_greedy"], setup["local"]["int8_greedy"])
    np.testing.assert_array_equal(got["int8_greedy"].numpy(),
                                  setup["jax"]["int8_greedy"])
    assert bool(got["int8_codes_equal"])
    assert got["int8_codes_equal_every_rank"]


def test_kv_cache_holds_local_heads_and_rows(setup, sharded):
    mesh, got = sharded
    data, fsdp, tensor = mesh
    llm = setup["cfg"].llm
    L = setup["job"]["inputs"]["text_ids"].shape[1]
    assert got["cache_shape"] == (llm.num_hidden_layers, 4 // (data * fsdp),
                                  L + NEW, llm.kv_heads // tensor,
                                  llm.head_dim)


def test_towers_and_vocabulary_are_cut_over_tensor(setup, sharded):
    """A rank's ViT ``q_proj``, deformable offsets, Q-Former query, GEGLU
    ``ff_in``, MMFSNet value, embedding and text head hold ``1 / tensor``
    of the whole model's rows."""
    mesh, got = sharded
    state = setup["job"]["state"]
    assert set(got["rows"]) == set(worker.CUT_ROWS)
    for n, rows in got["rows"].items():
        assert rows * mesh[2] == state[n].shape[0], n


def test_odd_batch_runs_replicated(setup, sharded):
    _, got = sharded
    assert torch.equal(got["odd_greedy"], setup["local"]["odd_greedy"])
