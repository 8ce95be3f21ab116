"""The port's other language models against the reference's, on the CPU.

The reduced configs of gemma-7b (GeGLU, tied embeddings), gemma3-4b (5
sliding-window layers to one global), deepseek-7b, pixtral-12b (patch
embeddings in place of the first positions) and musicgen-medium (4
codebooks, summed embeddings, one head of 4 x V rows), and a soft-capped
gemma; ``reduce_config`` on both sides, sparsity backend ``auto`` (rbgp4
at 0.5, ``min_dim=64``: the compact projections run the kernels' plain
versions). The reference's ``LMModel.init`` weights go through
``load_jax_params``. Held: the forward logits, and a prefill plus two
decode steps' logits and every cache leaf, within 1e-5 * max|ref|; the
loss and every gradient leaf at the start of a plain SGD run and after
its first step within 1e-4 (relative for the loss, of max|ref| a leaf).
gemma3-4b keeps one pattern period and one layer (7 of the reduced 17):
the same head / scanned period / tail split of the reference, at under
half the compile time. The forward logits come from the compiled
function that gives the reference's loss and gradients (``forward``
under ``lm_loss``), so each model compiles three reference functions:
that one, ``prefill`` and ``decode_step``.

Then the codebook data streams and serving.  ``mla``, ``mamba`` and
``rwkv`` have files of their own (``test_torch_mla.py``,
``test_torch_ssm.py``, ``test_torch_rwkv.py``), the full configs too
(``test_torch_arch_configs.py``); they use the helpers here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.data import RequestStream as JRequestStream
from repro.data import TokenStream as JTokenStream
from repro.models import LMModel as JLMModel
from repro.models.lm import lm_loss as j_lm_loss
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.utils import merge_trees, split_trainable
from repro_torch.bridge import flatten_jax_tree, load_jax_params
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import RequestStream, TokenStream
from repro_torch.models import LMModel
from repro_torch.serve import ContinuousEngine, StaticEngine, run_sequential

from test_torch_model import jax_tree_to_numpy

torch.set_num_threads(1)
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4


# -- helpers (the mla, ssm and rwkv files use them too) ----------------------

def build_arch_pair(arch: str, seed: int = 0, **kw):
    """The reduced ``arch`` on both sides (``kw`` replaces config fields on
    both), the reference's weights loaded into the port's model."""
    jcfg = j_reduce_config(j_get_config(arch),
                           sparsity_backend="auto").with_(**kw)
    cfg = reduce_config(get_config(arch)).with_(**kw)
    jm = JLMModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = LMModel(cfg, device="cpu")
    tree = jax_tree_to_numpy(jp)
    load_jax_params(tm, tree)
    return jm, jp, tm, tree


def arch_batch(cfg, B: int = 2, S: int = 10, seed: int = 0) -> dict:
    """numpy tokens (B, S[, n_cb]) and, for a vision model, patch
    embeddings."""
    rng = np.random.default_rng(seed)
    shape = (B, S) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_close(got, want, rtol: float, what: str = ""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= rtol * scale, (what, err, scale)


def jax_cache_by_layer(cfg, jcache) -> dict:
    """The reference's (head, scan, tail) cache as {port name: array}."""
    return flatten_jax_tree(cfg, {"stack": jax_tree_to_numpy(jcache)})


def assert_caches_close(tm, tcache, jcache, what):
    want = jax_cache_by_layer(tm.cfg, jcache)
    got = {f"stack.layers.{i}.{name}": t.numpy()
           for i, c in enumerate(tcache) for name, t in c.items()}
    assert set(got) == set(want), what
    for name, arr in got.items():
        if name.endswith(".pos"):
            np.testing.assert_array_equal(arr, want[name], err_msg=name)
        else:
            assert_close(arr, want[name], FWD_RTOL, f"{what} {name}")


def check_prefill_decode(jm, jp, tm, batch, cache_len: int = 16,
                         n_decode: int = 2, seed: int = 1):
    """A prefill and ``n_decode`` contiguous decode steps: logits and
    every cache leaf after each call."""
    cfg = tm.cfg
    B, S = batch["tokens"].shape[:2]
    jcache = jm.init_cache(B, cache_len, jnp.float32)
    want, jcache = jax.jit(jm.prefill)(jp, jax_batch(batch), jcache)
    tcache = tm.init_cache(B, cache_len, torch.float32)
    got, tcache = tm.prefill(batch["tokens"], tcache,
                             patch_embeds=batch.get("patch_embeds"))
    assert_close(got.numpy(), want, FWD_RTOL, "prefill logits")
    assert_caches_close(tm, tcache, jcache, "prefill")
    rng = np.random.default_rng(seed)
    decode = jax.jit(jm.decode_step)
    for i in range(n_decode):
        toks = rng.integers(0, cfg.vocab_size,
                            (B, 1) + batch["tokens"].shape[2:]).astype(
                                np.int32)
        want, jcache = decode(jp, jnp.asarray(toks), jcache, S + i)
        got, tcache = tm.decode_step(toks, tcache, S + i)
        assert_close(got.numpy(), want, FWD_RTOL, f"decode {i} logits")
    assert_caches_close(tm, tcache, jcache, "decode")


def port_loss_and_grads(tm, batch) -> tuple[float, dict]:
    params = dict(tm.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
        p.grad = None
    loss, _ = tm.loss(batch, train=True)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(False)
        p.grad = None
    return loss.item(), grads


def check_forward_and_two_sgd_steps(jm, jp, tm, batch, lr: float = 0.05):
    """The forward logits (and MoE aux loss), then the loss and every
    gradient leaf at two points of a plain SGD run (p -= lr * g): the
    weights it starts from, and those after the reference's first step,
    loaded into the port.  Each side stepping on its own gradients would
    compare two runs that drift apart by their float32 noise, amplified
    by the step; loading the reference's weights compares both at one
    point.  One compiled reference function gives the loss, its gradients
    and the logits (``LMModel.forward`` under ``lm_loss``, the reference's
    ``loss``).  The port model's weights are put back afterwards."""
    saved = {n: t.clone() for n, t in tm.state_dict().items()}
    train, static = split_trainable(jp)
    jb = jax_batch(batch)

    def jloss_fn(t):
        logits, aux = jm.forward(merge_trees(t, static), jb, train=True)
        ce = j_lm_loss(logits[:, :-1], jb["tokens"][:, 1:])
        return ce + aux.astype(jnp.float32), (logits, aux)

    loss_grad = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))
    for step in range(2):
        (jloss, (jlogits, jaux)), jgrads = loss_grad(train)
        if step == 0:
            got, aux = tm.forward(batch["tokens"], train=True,
                                  patch_embeds=batch.get("patch_embeds"))
            assert_close(got.detach().numpy(), jlogits, FWD_RTOL, "logits")
            assert abs(float(aux) - float(jaux)) <= FWD_RTOL * max(
                abs(float(jaux)), 1e-30)
        loss, grads = port_loss_and_grads(tm, batch)
        assert abs(loss - float(jloss)) <= GRAD_RTOL * abs(float(jloss)), (
            step, loss, float(jloss))
        want = flatten_jax_tree(tm.cfg, jax_tree_to_numpy(jgrads))
        assert set(want) == set(grads), step
        for name, g in grads.items():
            assert_close(g.numpy(), want[name], GRAD_RTOL,
                         f"step {step} {name}")
        train = jax.tree_util.tree_map(lambda p, g: p - lr * g, train,
                                       jgrads)
        load_jax_params(tm, jax_tree_to_numpy(merge_trees(train, static)))
    tm.load_state_dict(saved)


def check_recurrent_serving(jm, jp, tm, seed: int = 3):
    """A recurrent arch serves through the static engine, whose batches of
    equal prompt lengths give ``run_sequential``'s greedy streams; the
    continuous engine raises the reference's message (no fallback).  The
    recurrent state is replaced at every step, never written into: a
    decode step leaves the tensors of the cache it was given as they
    were (the attention layers' KV caches are written in place)."""
    reqs = RequestStream(tm.cfg.vocab_size, 4, prompt_lens=(5, 8),
                         gen_lens=(3, 4), seed=seed).requests()
    eng = StaticEngine(tm, batch=2)
    for r in reqs:
        eng.submit(r["prompt"], r["max_new_tokens"])
    got = eng.drain()
    want = run_sequential(tm, reqs)
    for r in reqs:
        np.testing.assert_array_equal(got[r["rid"]], want[r["rid"]])
    with pytest.raises(NotImplementedError) as jerr:
        JContinuousEngine(jm, jp, page_size=4, max_slots=2,
                          max_request_len=16)
    with pytest.raises(NotImplementedError) as err:
        ContinuousEngine(tm, page_size=4, max_slots=2, max_request_len=16)
    assert str(err.value) == str(jerr.value)
    assert "--engine static" in str(err.value)
    S = reqs[0]["prompt"].shape[0]
    cache = tm.init_cache(1, S + 1, torch.float32)
    _, cache = tm.prefill(reqs[0]["prompt"][None], cache)
    recurrent = ("h", "conv", "state", "x_tm", "x_cm")
    before = [{k: (v, v.clone()) for k, v in c.items() if k in recurrent}
              for c in cache]
    assert any(before)
    _, after = tm.decode_step(np.zeros((1, 1), np.int32), cache, S)
    for old, new in zip(before, after):
        for name, (t, copy) in old.items():
            assert torch.equal(t, copy), name
            assert new[name].data_ptr() != t.data_ptr(), name


# -- the dense, vision and codebook archs -------------------------------------

DENSE_CASES = {
    "gemma-7b": {},
    "gemma3-4b": {"n_layers": 7},
    "deepseek-7b": {},
    "pixtral-12b": {},
    "musicgen-medium": {},
    "gemma-7b-softcap": {"logit_softcap": 3.0, "n_layers": 1},
}


@pytest.fixture(scope="module", params=list(DENSE_CASES))
def dense_pair(request):
    case = request.param
    arch = case.removesuffix("-softcap")
    return build_arch_pair(arch, **DENSE_CASES[case])


def test_prefill_and_decode_match_reference(dense_pair):
    jm, jp, tm, _ = dense_pair
    check_prefill_decode(jm, jp, tm, arch_batch(tm.cfg))


def test_forward_loss_and_gradients_of_two_sgd_steps_match_reference(
        dense_pair):
    jm, jp, tm, _ = dense_pair
    check_forward_and_two_sgd_steps(jm, jp, tm, arch_batch(tm.cfg, seed=2))


def test_tied_heads_codebooks_and_patches_are_the_reference_layout():
    gemma = reduce_config(get_config("gemma-7b"))
    tied = LMModel(gemma, device="cpu")
    assert tied.head is None and "head" not in dict(tied.named_parameters())
    music = LMModel(reduce_config(get_config("musicgen-medium")),
                    device="cpu")
    assert len(music.embed) == 4
    assert tuple(music.head.shape) == (4 * 128, 64)
    logits, _ = music.forward(np.zeros((1, 3, 4), np.int32))
    assert tuple(logits.shape) == (1, 3, 4, 128)
    # patch embeddings replace exactly the first n_patches positions
    pix = LMModel(reduce_config(get_config("pixtral-12b")), device="cpu")
    batch = arch_batch(pix.cfg, B=1, S=8)
    plain = pix.forward(batch["tokens"])[0]
    patched = pix.forward(batch["tokens"],
                          patch_embeds=batch["patch_embeds"])[0]
    assert not torch.equal(plain[:, :4], patched[:, :4])


def test_codebook_loss_mask_broadcasts_as_the_reference():
    jm, jp, tm, _ = build_arch_pair("musicgen-medium", n_layers=1)
    batch = arch_batch(tm.cfg, B=2, S=6, seed=3)
    mask = np.ones((2, 6), np.float32)
    mask[0, 3:] = 0
    batch["loss_mask"] = mask
    (jloss, (jce, _)) = jm.loss(jp, jax_batch(batch))
    loss, (ce, _) = tm.loss(batch)
    assert abs(float(ce) - float(jce)) <= GRAD_RTOL * abs(float(jce))


def test_codebook_streams_equal_the_reference():
    want = JTokenStream(128, 3, 20, n_codebooks=4, seed=5)
    got = TokenStream(128, 3, 20, n_codebooks=4, seed=5)
    for step in (0, 3):
        np.testing.assert_array_equal(got.batch_at(step),
                                      want.batch_at(step))
    assert got.batch_at(0).shape == (3, 20, 4)
    jreqs = JRequestStream(128, 5, n_codebooks=4, seed=2).requests()
    reqs = RequestStream(128, 5, n_codebooks=4, seed=2).requests()
    for r, jr in zip(reqs, jreqs):
        assert r["prompt"].shape[1:] == (4,)
        np.testing.assert_array_equal(r["prompt"], jr["prompt"])
        assert r["max_new_tokens"] == jr["max_new_tokens"]


def test_codebook_model_serves_through_the_paged_engine():
    """(S, 4) prompts, (B, 1, 4) decode inputs and per-codebook greedy
    sampling: the continuous engine's streams equal ``run_sequential``."""
    tm = LMModel(reduce_config(get_config("musicgen-medium")).with_(
        n_layers=2), device="cpu")
    reqs = RequestStream(128, 3, prompt_lens=(4, 7), gen_lens=(3, 5),
                         n_codebooks=4, seed=0).requests()
    eng = ContinuousEngine(tm, page_size=4, max_slots=2, max_request_len=16)
    for r in reqs:
        eng.submit(r["prompt"], r["max_new_tokens"])
    got = eng.drain()
    want = run_sequential(tm, reqs, cache_len=eng.gather_tokens)
    for r in reqs:
        assert got[r["rid"]].shape == (r["max_new_tokens"], 4)
        np.testing.assert_array_equal(got[r["rid"]], want[r["rid"]])
