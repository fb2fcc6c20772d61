"""The port's SAE ops, projection ops and SAE-Top-k baseline against the JAX
package's, on the CPU.

The JAX SAE is carried across by ``ops.sae.from_numpy_state``; inputs are
made from a seed with numpy.  Float results are held at atol 1e-5 (f32, sums
in another order); ids and guesses are equal.  Tie order: JumpReLU leaves
many pooled activations at exactly 0, and both packages take the lowest id
first among ties.
"""

import csv
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.ops import projection as jproj
from taboo_brittleness_tpu.ops import sae as jsae
from taboo_brittleness_tpu.pipelines import sae_baseline as jbase
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch import feature_map as tfmap
from taboo_brittleness_tpu_torch.ops import projection as tproj
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.pipelines import sae_baseline as tbase

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_fixtures  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "..", "results", "fixtures")
ATOL = 1e-5
D, S = 32, 64


def _state(sae) -> dict:
    return {k: np.asarray(v) for k, v in sae._asdict().items()}


@pytest.fixture(scope="module")
def saes():
    j = jsae.init_random(jax.random.PRNGKey(3), d_model=D, d_sae=S)
    return j, tsae.from_numpy_state(_state(j), device="cpu")


def _x(seed: int, *shape: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got: torch.Tensor, want, atol: float = ATOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def test_encode_decode_reconstruct_match_jax(saes):
    j, t = saes
    x = _x(0, 3, 5, D) * 2.0
    acts = tsae.encode(t, torch.from_numpy(x))
    _close(acts, jsae.encode(j, jnp.asarray(x)))
    assert (acts == 0).float().mean() > 0.2          # the JumpReLU gate bites
    _close(tsae.decode(t, acts), jsae.decode(j, jsae.encode(j, jnp.asarray(x))))
    _close(tsae.reconstruct(t, torch.from_numpy(x)),
           jsae.reconstruct(j, jnp.asarray(x)))
    assert t.d_model == D and t.d_sae == S


@pytest.mark.parametrize("ids", [
    [3, 17, -1],                                  # shared, padded
    [[3, 17, -1], [5, -1, -1], [-1, -1, -1]],     # per row, one identity row
    [[8, 8, 2], [0, 63, 9], [11, 2, 11]],         # per row, repeated ids
])
def test_ablate_latents_matches_jax(saes, ids):
    j, t = saes
    x = _x(1, 3, 4, D) * 2.0
    ids = np.asarray(ids, np.int32)
    got = tsae.ablate_latents(t, torch.from_numpy(x), torch.from_numpy(ids))
    _close(got, jsae.ablate_latents(j, jnp.asarray(x), jnp.asarray(ids)))
    if ids.ndim == 2 and (ids[2] < 0).all():
        assert torch.equal(got[2], torch.from_numpy(x[2]))


def test_ablate_latents_all_inert_is_exact_identity_on_bf16(saes):
    _, t = saes
    x = torch.from_numpy(_x(2, 4, 6, D) * 3.0).to(torch.bfloat16)
    for ids in (torch.full((4,), -1), torch.full((4, 5), -1)):
        assert torch.equal(tsae.ablate_latents(t, x, ids), x)


def test_mean_response_acts_and_top_latents_with_zero_ties(saes):
    j, t = saes
    resid = _x(3, 4, 7, D)
    mask = np.random.default_rng(4).random((4, 7)) > 0.4
    mask[3] = False                                   # no response tokens
    got = tsae.mean_response_acts(t, torch.from_numpy(resid), torch.from_numpy(mask))
    want = jax.vmap(lambda r, m: jsae.mean_response_acts(j, r, m))(
        jnp.asarray(resid), jnp.asarray(mask))
    _close(got, want)
    # A quarter of the latents tie at exactly 0 within the top 20.
    pooled = got.clone()
    pooled[:, S // 4:] = torch.clamp(pooled[:, S // 4:], max=0.0) * 0.0
    ids, vals = tsae.top_latents(pooled, 20)
    jids, jvals = jax.vmap(lambda a: jsae.top_latents(a, 20))(jnp.asarray(pooled.numpy()))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals, jvals)
    assert ids.dtype == torch.int32


def test_correlation_estimators_match_jax(saes):
    j, t = saes
    rng = np.random.default_rng(5)
    N = 37                                            # does not divide chunk=8
    x = _x(6, N, D) * 2.0
    y = rng.normal(size=(N,)).astype(np.float32)
    w = (rng.random(N) > 0.25).astype(np.float32)
    acts = jsae.encode(j, jnp.asarray(x))
    dense = tsae.latent_secret_correlation(
        torch.from_numpy(np.array(acts)), torch.from_numpy(y), torch.from_numpy(w))
    _close(dense, jsae.latent_secret_correlation(acts, jnp.asarray(y), jnp.asarray(w)))
    stream = tsae.latent_secret_correlation_stream(
        t, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w), chunk=8)
    _close(stream, jsae.latent_secret_correlation_stream(
        j, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), chunk=8), atol=2e-4)
    _close(stream, dense.numpy(), atol=2e-4)


def test_scores_and_alignment_match_jax(saes):
    j, t = saes
    embed = _x(7, 11, D)
    _close(tsae.latent_secret_alignment(t, torch.from_numpy(embed), 4),
           jsae.latent_secret_alignment(j, jnp.asarray(embed), jnp.asarray(4)))
    acts, corr = np.abs(_x(8, 6, S)), _x(9, S)
    _close(tsae.score_latents(torch.from_numpy(acts), torch.from_numpy(corr)),
           jsae.score_latents(jnp.asarray(acts), jnp.asarray(corr)))


def test_remove_subspace_matches_jax_shared_and_per_row():
    x = _x(10, 2, 3, D)
    u = np.asarray(jproj.random_subspace(jax.random.PRNGKey(7), D, 2))
    want = jproj.remove_subspace(jnp.asarray(x), jnp.asarray(u))
    _close(tproj.remove_subspace(torch.from_numpy(x), torch.from_numpy(u)), want)
    rows = np.stack([u, np.pad(u[:, :1], ((0, 0), (0, 1)))])      # [2, D, 2]
    _close(tproj.remove_subspace(torch.from_numpy(x), torch.from_numpy(rows)),
           jproj.remove_subspace(jnp.asarray(x), jnp.asarray(rows)))
    bf = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(tproj.remove_subspace(bf, torch.zeros(D, 3)), bf)


def test_principal_subspace_projectors_match_jax():
    rng = np.random.default_rng(11)
    scales = np.array([9.0, 5.0, 3.0, 1.5] + [0.1] * (D - 4), np.float32)
    data = (rng.normal(size=(40, D)) * scales).astype(np.float32)
    ju, jvar = jproj.principal_subspace(jnp.asarray(data), rank=4)
    tu, tvar = tproj.principal_subspace(torch.from_numpy(data), rank=4)
    _close(tvar, jvar, atol=1e-3)
    s = np.linalg.svd(data - data.mean(0), compute_uv=False)
    for r in (1, 2, 4):
        assert s[r - 1] - s[r] > 0.1 * s[0]          # a clear gap at rank r
        p_t = (tu[:, :r] @ tu[:, :r].T).numpy()
        p_j = np.asarray(ju[:, :r] @ ju[:, :r].T)
        np.testing.assert_allclose(p_t, p_j, atol=ATOL)


def test_random_subspace_is_orthonormal_and_seeded():
    a = tproj.random_subspace(torch.Generator().manual_seed(42000), D, 4)
    b = tproj.random_subspace(torch.Generator().manual_seed(42000), D, 4)
    assert torch.equal(a, b) and a.shape == (D, 4)
    torch.testing.assert_close(a.T @ a, torch.eye(4), atol=1e-5, rtol=0)
    assert (torch.diagonal(torch.linalg.qr(a).R) != 0).all()


def test_feature_map_copy_matches():
    from taboo_brittleness_tpu import feature_map as jfmap

    assert tfmap.FEATURE_MAP == jfmap.FEATURE_MAP
    assert tfmap.latents_to_word_guesses([13740, 0, 5404, 13740]) == ["moon", "ship"]


def _fixture_setup():
    _, cfg, _, config_j, sae_j = make_fixtures.build_setup()
    m = config_j.model
    config_t = tconfig.Config(
        model=tconfig.ModelConfig(layer_idx=m.layer_idx, top_k=m.top_k,
                                  arch=m.arch, dtype=m.dtype,
                                  param_dtype=m.param_dtype),
        word_plurals=dict(config_j.word_plurals),
        prompts=list(config_j.prompts))
    return config_j, sae_j, config_t, tsae.from_numpy_state(_state(sae_j),
                                                            device="cpu")


def _committed_csv():
    with open(os.path.join(FIXTURES, "baseline_metrics.csv")) as f:
        return list(csv.reader(f))


def test_sae_baseline_reproduces_committed_csv(tmp_path):
    config_j, sae_j, config_t, sae_t = _fixture_setup()
    fmap = {w: [i] for i, w in enumerate(make_fixtures.WORDS)}
    processed = os.path.join(FIXTURES, "processed")
    fresh = tbase.analyze_sae_baseline(config_t, sae_t, words=make_fixtures.WORDS,
                                       processed_dir=processed, feature_map=fmap)
    want = jbase.analyze_sae_baseline(config_j, sae_j, words=make_fixtures.WORDS,
                                      processed_dir=processed, feature_map=fmap)
    assert fresh == want
    out = str(tmp_path / "baseline_metrics.csv")
    tbase.save_metrics_csv(fresh, out)
    with open(out) as f:
        assert list(csv.reader(f)) == _committed_csv()

    # The pooled top latents themselves, ids and activations.
    stacked, masks, owners = tbase.collect_pairs(config_t, make_fixtures.WORDS,
                                                 processed)
    assert len(owners) == 2 * len(make_fixtures.WORDS)
    ids, vals = tbase.top_latents_for_pairs(sae_t, stacked, masks, top_k=8)
    jids, jvals = jbase.top_latents_for_pairs(sae_j, stacked, masks, top_k=8)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(vals, jvals, atol=ATOL, rtol=0)


def test_cli_sae_baseline_writes_the_committed_csv(tmp_path, monkeypatch, capsys):
    _, sae_j, _, _ = _fixture_setup()
    npz = tmp_path / "sae.npz"
    np.savez(npz, **{{"w_enc": "W_enc", "w_dec": "W_dec"}.get(k, k): v
                     for k, v in _state(sae_j).items()})
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tfmap, "FEATURE_MAP",
                        {w: [i] for i, w in enumerate(make_fixtures.WORDS)})
    monkeypatch.setattr(tbase, "FEATURE_MAP", tfmap.FEATURE_MAP)
    yaml_cfg = tmp_path / "cfg.yaml"
    yaml_cfg.write_text(
        "model:\n  layer_idx: 2\n  top_k: 3\n"
        "word_plurals:\n" + "".join(f"  {w}: [{w}, {w}s]\n"
                                    for w in make_fixtures.WORDS)
        + "prompts:\n" + "".join(f"  - \"{p}\"\n" for p in make_fixtures.PROMPTS))
    rc = cli.main(["sae-baseline", "-c", str(yaml_cfg), "--device", "cpu",
                   "--sae-npz", str(npz),
                   "--processed-dir", os.path.join(FIXTURES, "processed")])
    assert rc == 0
    with open(tmp_path / "results" / "tables" / "baseline_metrics.csv") as f:
        assert list(csv.reader(f)) == _committed_csv()
    assert "metrics ->" in capsys.readouterr().out
