"""The towers' and the vocabulary's tensor-parallel pairs
(`parallel.tensor`, `parallel.partition.plan`) against the whole modules,
in one process.

Two ranks run as two threads of this process on a `ThreadGroup`, whose
collectives are made by hand (`all_reduce` sums the ranks' tensors in rank
order, `all_gather` concatenates them): no process group, no second
process.  Each rank holds its cut of the tiny preset (every weight seeded
noise, the resamplers' dropout at 0.1), made by `apply_tensor_cuts` from
the plan of the whole model.  Checked, in fp32:

  * each new module kind (the ViT layer, the adapter's injector and
    extractor with their deformable attentions, the ConvFFN, both
    Q-Formers' layers with dropout, the UNet's transformer blocks, an
    MMFSNet block on the factorised and on the differentiable route, the
    vocab-parallel embedding and text head): the output within 1e-5 of
    the whole module's scale and the same bits on both ranks; the input
    and parameter gradients likewise, a cut parameter's gathered from the
    ranks (`tensor_join`), a whole one the same bits on both ranks;
  * ``ff_in``'s ``[value_r | gate_r]`` cut: the rank's rows are the same
    rows of both halves, and the two ranks' GEGLU partials (the plain
    version of the fused kernel, bias zero) summed by hand plus ``b2`` are
    the whole GEGLU;
  * a UNet block whose heads ``tensor`` does not divide keeps its
    attention whole (no group, the whole weights) and cuts its GEGLU;
  * a vocabulary that ``tensor`` does not divide stays whole.
"""

import copy
import dataclasses
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch.models.deform_attn import grid_reference_points
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.ops.geglu import geglu_plain
from mm_interleaved_tpu_torch.parallel.partition import (plan,
                                                         tensor_blocks,
                                                         tensor_join)
from mm_interleaved_tpu_torch.parallel.tensor import (apply_tensor_cuts,
                                                      tensor_cuts)

RANKS = 2
TOL = 1e-5


class ThreadGroup:
    """A ``tensor`` group of ``n`` ranks, each a thread of this process."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=60)
        self.slots = [None] * n
        self.local = threading.local()

    @property
    def rank(self) -> int:
        return self.local.rank

    def exchange(self, x):
        """Every rank's ``x`` (cloned), in rank order."""
        self.slots[self.rank] = x.detach().clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got


@pytest.fixture(autouse=True)
def thread_collectives(monkeypatch):
    """`torch.distributed`'s calls on a `ThreadGroup` made by hand."""
    orig = {k: getattr(dist, k) for k in ("all_reduce", "all_gather",
                                          "get_rank", "get_world_size")}

    def all_reduce(x, group=None, **kw):
        if not isinstance(group, ThreadGroup):
            return orig["all_reduce"](x, group=group, **kw)
        parts = group.exchange(x)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        x.copy_(total)

    def all_gather(out, x, group=None, **kw):
        if not isinstance(group, ThreadGroup):
            return orig["all_gather"](out, x, group=group, **kw)
        for o, p in zip(out, group.exchange(x)):
            o.copy_(p)

    def get_rank(group=None):
        if isinstance(group, ThreadGroup):
            return group.rank
        return orig["get_rank"](group)

    def get_world_size(group=None):
        if isinstance(group, ThreadGroup):
            return group.n
        return orig["get_world_size"](group)

    for k, fn in dict(all_reduce=all_reduce, all_gather=all_gather,
                      get_rank=get_rank,
                      get_world_size=get_world_size).items():
        monkeypatch.setattr(dist, k, fn)


def run_threads(group: ThreadGroup, fn):
    """``fn(rank)`` on every rank's thread; their results in rank order."""
    out = [None] * group.n
    errors = []

    def body(r):
        group.local.rank = r
        try:
            out[r] = fn(r)
        except BaseException as e:  # re-raised below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(group.n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def tiny_cfg(vocab_size=None, head_dim=None):
    cfg = tcfg.tiny_config(with_image_decoder=True, scan_layers=False)
    vis, dec = cfg.visual, cfg.image_decoder
    dec = dataclasses.replace(
        dec, vae_decode_dtype="float32",
        perceiver=dataclasses.replace(dec.perceiver, dropout=0.1))
    if head_dim is not None:
        dec = dataclasses.replace(dec, unet=dataclasses.replace(
            dec.unet, attention_head_dim=head_dim))
    llm = cfg.llm
    if vocab_size is not None:
        llm = dataclasses.replace(llm, vocab_size=vocab_size)
    return dataclasses.replace(
        cfg, llm=llm, image_decoder=dec,
        visual=dataclasses.replace(vis, perceiver=dataclasses.replace(
            vis.perceiver, dropout=0.1)))


def seeded_model(cfg, seed=0):
    """The tiny model, every weight seeded noise (no zero-initialised gate
    hides a branch)."""
    model = build_model(cfg, "cpu", torch.float32, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p + 0.1 * torch.randn(p.shape, generator=g))
    return model


class Ranks:
    """The whole model, the cuts of its plan at ``tensor = 2`` and each
    rank's cut copy on one `ThreadGroup`."""

    def __init__(self, cfg):
        self.whole = seeded_model(cfg)
        self.cuts = tensor_cuts(self.whole, {"tensor": RANKS})
        self.group = ThreadGroup(RANKS)
        self.models = []
        for r in range(RANKS):
            m = copy.deepcopy(self.whole)
            apply_tensor_cuts(m, self.cuts, r, RANKS, self.group)
            self.models.append(m)


@pytest.fixture(scope="module")
def ranks():
    return Ranks(tiny_cfg())


def _noise(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _forward_backward(module, fn, inputs, seed, train, grad=True):
    """``fn(module, *inputs)`` (train mode with a seeded generator when
    ``train``) and, with ``grad``, its backward against a seeded upstream
    gradient: the output, the inputs' gradients and the parameters'."""
    module.train(train)
    xs = [x.clone().requires_grad_(grad and x.is_floating_point())
          for x in inputs]
    for p in module.parameters():
        p.grad = None
    gen = torch.Generator().manual_seed(seed)
    with torch.set_grad_enabled(grad):
        out = fn(module, *xs, gen)
    if not grad:
        return out.detach(), [], {}
    out.backward(_noise(out.shape, seed + 1))
    return (out.detach(), [x.grad for x in xs if x.requires_grad],
            {n: p.grad for n, p in module.named_parameters()
             if p.grad is not None})


def _close(got, want, what):
    scale = max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=TOL * scale, err_msg=what)


def check_module(rk: Ranks, path, fn, inputs, train=False, grad=True,
                 seed=7, cut=True):
    """The module at ``path`` on every rank against the whole one; its
    parameters that ``fn`` reaches are cut (``cut``) or all whole."""
    want = _forward_backward(rk.whole.get_submodule(path), fn, inputs, seed,
                             train, grad)
    got = run_threads(rk.group, lambda r: _forward_backward(
        rk.models[r].get_submodule(path), fn, inputs, seed, train, grad))
    out0 = got[0][0]
    for r in range(1, RANKS):
        assert torch.equal(got[r][0], out0), "outputs differ between ranks"
    _close(out0, want[0], "output")
    for i, w in enumerate(want[1]):
        for r in range(1, RANKS):
            assert torch.equal(got[r][1][i], got[0][1][i]), f"input grad {i}"
        _close(got[0][1][i], w, f"input grad {i}")
    n_cut = 0
    for leaf, w in want[2].items():
        name = f"{path}.{leaf}"
        if name in rk.cuts:
            n_cut += 1
            g = tensor_join([got[r][2][leaf] for r in range(RANKS)], name,
                            rk.cuts[name])
        else:
            for r in range(1, RANKS):
                assert torch.equal(got[r][2][leaf], got[0][2][leaf]), name
            g = got[0][2][leaf]
        _close(g, w, name)
    if grad:
        assert bool(n_cut) == cut, path


B = 2


def _x(*shape, seed=0):
    return _noise(shape, seed)


def _vit(m, x, g):
    return m(x)


def _injector(m, q, feat, g):
    ref = torch.from_numpy(grid_reference_points(((4, 4),)))[None]
    return m(q, ref, feat)


def _extractor(m, q, feat, g):
    ref = torch.from_numpy(grid_reference_points(((8, 8), (4, 4),
                                                  (2, 2))))[None]
    return m(q, ref, feat)


def _layer(m, x, enc, g):
    return m(x, enc, generator=g)


def _block(m, x, ctx, g):
    return m(x, ctx)


def _mmfs(m, values, sample, g):
    mask = torch.tensor([[1, 1, 0], [1, 0, 0]])
    return m(sample, m.prepare(values, mask))


def _embed(m, ids, g):
    return m.embed(ids)


def _head(m, h, g):
    return m(h)


IDS = torch.tensor([[1, 5, 64, 65, 127, 0], [120, 63, 2, 3, 100, 122]])
# (path, fn, inputs, train mode): the tiny preset's widths
CASES = {
    "vit_layer": ("visual_tokenizer.encoder.layers.1", _vit,
                  [_x(B, 17, 32)], False),
    "injector": ("visual_tokenizer.encoder.injectors.0", _injector,
                 [_x(B, 16, 32), _x(B, 84, 32, seed=1)], False),
    "extractor": ("visual_tokenizer.encoder.extractors.0", _extractor,
                  [_x(B, 84, 32), _x(B, 16, 32, seed=1)], False),
    "conv_ffn": ("visual_tokenizer.encoder.extractors.0.ffn", _vit,
                 [_x(B, 84, 32)], False),
    "qformer_layer": ("visual_tokenizer.perceiver_resampler.layers.0",
                      _layer, [_x(B, 4, 16), _x(B, 17, 32, seed=1)], True),
    "decoder_qformer_layer": ("image_decoder.perceiver_resampler.layers.0",
                              _layer, [_x(B, 5, 16), _x(B, 9, 32, seed=1)],
                              True),
    "unet_block_2_heads": ("image_decoder.unet.down_0_attn_0.block", _block,
                           [_x(B, 16, 16), _x(B, 5, 16, seed=1)], False),
    "unet_block_4_heads": ("image_decoder.unet.mid_attn.block", _block,
                           [_x(B, 4, 32), _x(B, 5, 16, seed=1)], False),
    "mmfs_net_block": ("image_decoder.unet.mmfs_net.down_blocks_0", _mmfs,
                       [_x(B, 3, 340, 32), _x(B, 4, 4, 16, seed=1)], False),
    "embed_tokens": ("mm_decoder", _embed, [IDS], False),
    "text_head": ("text_decoder", _head, [_x(B, 6, 32)], False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_cut_two_ways_equals_whole(ranks, case):
    path, fn, inputs, train = CASES[case]
    check_module(ranks, path, fn, inputs, train=train)


def test_mmfs_net_block_factorised_route_equals_whole(ranks):
    """Without autograd the UNet branch takes the factorised readout (the
    mi kernel's plain version) on the local heads' image side."""
    path, fn, inputs, _ = CASES["mmfs_net_block"]
    check_module(ranks, path, fn, inputs, grad=False)


def test_unet_ffn_geglu_fused_route_equals_whole(ranks):
    """Without autograd the block's GEGLU takes the fused kernel's plain
    version on the local ``[value_r | gate_r]``, ``ff_out``'s bias after
    the sum."""
    path, fn, inputs, _ = CASES["unet_block_4_heads"]
    check_module(ranks, path, fn, inputs, grad=False)


def test_ff_in_holds_the_same_rows_of_value_and_gate(ranks):
    name = "image_decoder.unet.mid_attn.block.ff_in"
    assert tensor_blocks(f"{name}.weight") == 2
    whole = ranks.whole.get_submodule(name)
    h = _x(B, 4, 32, seed=3)
    blk = ranks.whole.get_submodule("image_decoder.unet.mid_attn.block")
    w2, b2 = blk.ff_out.weight, blk.ff_out.bias
    Fh = w2.shape[1]
    with torch.no_grad():
        want = geglu_plain(h, whole.weight, whole.bias, w2, b2)
        total = b2.clone()
        for r, m in enumerate(ranks.models):
            local = m.get_submodule(name)
            n = Fh // RANKS
            rows = torch.cat([torch.arange(r * n, (r + 1) * n),
                              Fh + torch.arange(r * n, (r + 1) * n)])
            assert torch.equal(local.weight, whole.weight[rows])
            assert torch.equal(local.bias, whole.bias[rows])
            out = m.get_submodule("image_decoder.unet.mid_attn.block.ff_out")
            assert torch.equal(out.weight, w2[:, r * n:(r + 1) * n])
            total = total + geglu_plain(h, local.weight, local.bias,
                                        out.weight, torch.zeros_like(b2))
    _close(total, want, "GEGLU summed over the ranks")


def test_unet_block_whose_heads_tensor_does_not_divide():
    """``attention_head_dim = 16``: the 16-channel blocks have one head, so
    their attention stays whole (the whole weights on both ranks, no
    group) while their GEGLU is cut; the 2-head blocks are cut whole."""
    rk = Ranks(tiny_cfg(head_dim=16))
    path = "image_decoder.unet.down_0_attn_0.block"
    placed = plan(rk.whole, {"tensor": RANKS})
    for leaf in ("attn1_q", "attn1_out", "attn2_k"):
        assert placed[f"{path}.{leaf}.weight"].tensor is None
    assert placed[f"{path}.ff_in.weight"].tensor == 0
    assert placed["image_decoder.unet.mid_attn.block.attn1_q.weight"] \
        .tensor == 0
    for m in rk.models:
        blk = m.get_submodule(path)
        assert blk.attn_group is None and blk.ffn_group is rk.group
        assert torch.equal(blk.attn1_q.weight, rk.whole.get_submodule(
            path).attn1_q.weight)
        assert blk.ff_in.weight.shape[0] == 8 * 16 // RANKS
    check_module(rk, path, _block, [_x(B, 16, 16), _x(B, 5, 16, seed=1)])


def test_vocabulary_that_tensor_does_not_divide_stays_whole():
    """123 rows (``tensor = 2`` does not divide them): the embedding and
    the text head stay whole on both ranks and compute the whole ones'
    bits; the towers are still cut."""
    rk = Ranks(tiny_cfg(vocab_size=123))
    assert not any(n.startswith(("text_decoder.", "mm_decoder.embed"))
                   for n in rk.cuts)
    assert any(n.startswith("visual_tokenizer.") for n in rk.cuts)
    for m in rk.models:
        assert m.mm_decoder.tensor_group is None
        assert m.text_decoder.tensor_group is None
        assert m.text_decoder.head.weight.shape[0] == 123
    ids = IDS.clamp(max=122)
    check_module(rk, "mm_decoder", _embed, [ids], cut=False)
    check_module(rk, "text_decoder", _head, [_x(B, 6, 32)], cut=False)


def test_embedding_rows_and_lookup_are_local(ranks):
    """Each rank holds half the rows and returns zeros for an id it does
    not hold before the sum (the sum is exact: one rank holds each id)."""
    whole = ranks.whole.mm_decoder.embed_tokens.weight
    for r, m in enumerate(ranks.models):
        w = m.mm_decoder.embed_tokens.weight
        assert torch.equal(w, whole[r * 64:(r + 1) * 64])
    out = run_threads(ranks.group, lambda r: ranks.models[r].mm_decoder
                      .embed(IDS).detach())
    assert torch.equal(out[0], F.embedding(IDS, whole))
