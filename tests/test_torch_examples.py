"""The port's examples (``repro_torch.examples``) against the reference's.

Each example runs end to end on the CPU at its smoke size. On params made
by the reference's ``init(PRNGKey(0))`` and bridged (``repro_torch.bridge``),
with prompts made by numpy and handed to both packages:

- quickstart's greedy and LayerSkip tokens equal the reference's
  ``engine.generate`` and ``layerskip_generate`` under the near-tie rule (a
  divergence passes only where the reference's top-1/top-2 gap is below
  1e-4, and is reported);
- image_generation's greedy contrastive tokens equal the reference's
  ``generate_contrastive`` under the same rule, the gap taken on the mixed
  and masked logits;
- train_small's first three logged losses equal the reference's
  ``train_loop.train`` at f32 tolerance (atol 2e-5, rtol 2e-4), at batch 2
  x seq 32 so that the file stays short.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import engine as jengine
from repro.core import layerskip as jlayerskip
from repro.models import get_model as jget_model
from repro.models import vlm as jvlm
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.examples import (image_generation, quickstart, serve_batched,
                                  speech_translation, train_small)
from repro_torch.models import get_model, vlm
from tests.test_torch_serve import _ref_gap, assert_tokens_match

F32 = dict(atol=2e-5, rtol=2e-4)
NEAR_TIE = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs (many tiny eager ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch):
    jcfg = SMOKE_CONFIGS[arch].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config(arch).replace(dtype="float32")
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, get_model(tcfg), tparams


# ------------------------------------------------------------ end to end
def test_quickstart_runs_on_the_cpu():
    model, params = quickstart.build(CPU)
    with torch.inference_mode():
        out = quickstart.run(model, params, CPU)
    assert tuple(out["top_p"].shape) == tuple(out["quant"].shape) == (2, quickstart.N_NEW)
    assert torch.equal(out["layerskip"], out["greedy"])
    assert sum(out["quant_modes"].values()) > 0 and 0.0 <= out["acceptance"] <= 1.0


def test_serve_batched_runs_on_the_cpu():
    m = serve_batched.run("cpu")
    assert m["n_requests"] == 8 and m["tokens_per_s"] > 0
    assert 0.0 < m["mean_slot_occupancy"] <= 1.0


def test_speech_translation_runs_on_the_cpu():
    with torch.inference_mode():
        st = speech_translation.run_st(*speech_translation.build("whisper-base", CPU), CPU)
        ss = speech_translation.run_ss(*speech_translation.build("seamless-m4t", CPU), CPU)
    assert tuple(st["tokens"].shape) == (speech_translation.BATCH, speech_translation.MAX_NEW)
    assert bool(torch.isfinite(st["scores"]).all()) and all(st["matches"])
    assert ss["units"].shape[0] == 2 and bool(torch.isfinite(ss["waveform"]).all())
    assert all(ss["matches"])


def test_image_generation_runs_on_the_cpu():
    model, params = image_generation.build(CPU)
    with torch.inference_mode():
        out = image_generation.run(model, params, CPU)
    off = vlm.image_token_offset(model.config)
    assert bool((out["top_p"] >= off).all()) and out["matches"]
    assert len(out["served"][2]) == 8 and out["caption"].shape == (1, 8)


def test_train_small_runs_on_the_cpu(tmp_path):
    model = get_model(train_small.CFG_100M)
    out = train_small.run(model, None, CPU, steps=2, batch=1, seq=16,
                          ckpt=str(tmp_path / "ts.npz"), log_every=1, ckpt_every=0)
    assert len(out["history"]) == 2 and np.isfinite(out["last"])
    with np.load(tmp_path / "ts.npz") as f:
        assert any(k.startswith("params/") for k in f.files)


# ------------------------------------------------------------ against the reference
def test_quickstart_greedy_and_layerskip_match_the_reference():
    jmodel, jparams, model, params = _pair("llama3.2-1b")
    prompts = quickstart.prompts_for(model.config, CPU)
    with torch.inference_mode():
        out = quickstart.run(model, params, CPU, prompts=prompts)
    jp = jnp.asarray(prompts.numpy())
    want = np.asarray(jengine.generate(jmodel, jparams, jp,
                                       max_new_tokens=quickstart.N_NEW)["tokens"])
    jls = np.asarray(jlayerskip.layerskip_generate(
        jmodel, jparams, jp, exit_layer=1, n_draft=4,
        max_new_tokens=quickstart.N_NEW)["tokens"])
    assert np.array_equal(jls, want)  # the reference's own lossless check
    for name in ("greedy", "layerskip"):
        for r in range(prompts.shape[0]):
            got = out[name][r].numpy()
            assert_tokens_match(got, want[r], lambda i: _ref_gap(
                jmodel, jparams, prompts[r].numpy(), want[r][:i]), f"quickstart {name} row {r}")


def _cfg_gap(jmodel, jparams, prompt, prefix, off, guidance):
    """The reference's deciding gap for T-I token ``len(prefix)``: top-1/
    top-2 of the mixed logits, masked to the image range."""
    seq = np.concatenate([np.asarray(prompt, np.int32), np.asarray(prefix, np.int32)])
    cond, _ = jengine.prefill(jmodel, jparams, jnp.asarray(seq[None]),
                              jnp.asarray([len(seq)], jnp.int32), len(seq) + 1, None)
    useq = np.concatenate([[0], np.asarray(prefix, np.int32)]).astype(np.int32)
    unc, _ = jengine.prefill(jmodel, jparams, jnp.asarray(useq[None]),
                             jnp.asarray([len(useq)], jnp.int32), len(useq) + 1, None)
    mixed = np.asarray(jvlm.contrastive_logits(cond, unc, guidance))[0][off:]
    top2 = np.sort(mixed)[-2:]
    return float(top2[1] - top2[0])


def test_image_generation_contrastive_tokens_match_the_reference():
    jmodel, jparams, model, params = _pair("chameleon-34b")
    prompt = image_generation.prompt_for(model.config, CPU)
    with torch.inference_mode():
        out = image_generation.run(model, params, CPU, prompt=prompt)
    n_img = model.config.vlm.n_image_tokens
    want = np.asarray(jengine.generate_contrastive(
        jmodel, jparams, jnp.asarray(prompt.numpy()), uncond_token=0, n_image_tokens=n_img,
        guidance=image_generation.GUIDANCE)["tokens"])[0]
    off = vlm.image_token_offset(model.config)
    assert_tokens_match(out["greedy_cfg"].numpy(), want, lambda i: _cfg_gap(
        jmodel, jparams, prompt[0].numpy(), want[:i], off, image_generation.GUIDANCE),
        "image_generation greedy T-I")


def test_train_small_losses_match_the_reference():
    cfg = train_small.CFG_100M
    jcfg = JModelConfig(name=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
                        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
                        tie_embeddings=cfg.tie_embeddings, dtype=cfg.dtype)
    steps, batch, seq = 3, 2, 32
    ref = jtl.train(jcfg, data=jdata.token_stream(jcfg, batch=batch, seq_len=seq),
                    steps=steps, opt_cfg=jopt.OptimizerConfig(lr=6e-4, warmup_steps=20,
                                                              total_steps=steps),
                    log_every=1)
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0))
    params = bridge.params_to_torch(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    out = train_small.run(get_model(cfg), params, CPU, steps=steps, batch=batch, seq=seq,
                          ckpt=None, log_every=1, ckpt_every=0)
    got = [m["loss"] for m in out["history"]]
    want = [m["loss"] for m in ref.metrics_history]
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, **F32)
