"""Checkpoint/resume tests (SURVEY.md section 5: subsystem absent in the
reference; here interruption must be invisible in the result bits)."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams, price
from mc_tpu.checkpoint import Checkpoint, chunked_price, load_checkpoint

SIM = SimParams(n_paths=40_000, n_steps=10)
CHUNK = 8 * 128 * 8  # 8192 paths/chunk -> 5 chunks


def test_chunked_matches_plain_price():
    """Chunked accumulation equals the one-shot price within fp noise.

    Chunking resumes via path_offset, which rides the classic per-path
    counter stream — so the one-shot side must pin method="terminal"
    (since round 5 a bare price() resolves to the terminal_pair fast
    path, a DIFFERENT stream by design; see BASELINE.md's default
    decision).  The pair default is still cross-checked statistically.
    """
    a = chunked_price(sim=SIM, chunk_paths=CHUNK, tile_rows=8)
    b = price(sim=SIM, tile_rows=8, method="terminal")
    assert float(a.price) == pytest.approx(float(b.price), rel=1e-6)
    assert float(a.stderr) == pytest.approx(float(b.stderr), rel=1e-4)
    c = price(sim=SIM, tile_rows=8)  # terminal_pair default
    joint = (float(a.stderr) ** 2 + float(c.stderr) ** 2) ** 0.5
    assert abs(float(a.price) - float(c.price)) < 4 * joint


def test_resume_bitwise_identical(tmp_path):
    ck = str(tmp_path / "run.npz")
    full = chunked_price(sim=SIM, chunk_paths=CHUNK,
                         tile_rows=8)

    # Interrupted run: price only the first 2 chunks by lying about n_paths
    # progress — simulate by running with checkpointing, then truncating.
    chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck, tile_rows=8)
    state = load_checkpoint(ck)
    assert state.paths_done >= SIM.n_paths

    # Rewind the checkpoint to after chunk 2 and resume.
    partial = Checkpoint(paths_done=2 * CHUNK, n_paths=SIM.n_paths,
                         acc=state.acc * 0, comp=state.comp * 0,
                         meta=state.meta)
    # Recompute the first two chunks to get their true accumulator state:
    ck2 = str(tmp_path / "run2.npz")
    chunked_price(sim=SimParams(n_paths=2 * CHUNK, n_steps=SIM.n_steps),
                  chunk_paths=CHUNK, checkpoint_path=ck2,
                  tile_rows=8)
    s2 = load_checkpoint(ck2)
    partial.acc, partial.comp = s2.acc, s2.comp
    partial.meta = state.meta
    partial.save(ck)

    resumed = chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck,
                            resume=True, tile_rows=8)
    assert float(resumed.price) == float(full.price)  # bitwise
    assert float(resumed.stderr) == float(full.stderr)


def test_resume_guards(tmp_path):
    ck = str(tmp_path / "run.npz")
    with pytest.raises(FileNotFoundError):
        chunked_price(sim=SIM, checkpoint_path=ck, resume=True, tile_rows=8)
    chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck, tile_rows=8)
    with pytest.raises(ValueError):
        chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck,
                      resume=True, payoff="bullet_call",
                      tile_rows=8)


def test_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "c.npz")
    ck = Checkpoint(paths_done=100, n_paths=200,
                    acc=np.ones((2, 8, 128), np.float32),
                    comp=np.zeros((2, 8, 128), np.float32),
                    meta=dict(seed=1, payoff="vanilla_call", method="euler",
                              chunk_paths=100))
    ck.save(p)
    back = load_checkpoint(p)
    assert back.paths_done == 100
    np.testing.assert_array_equal(back.acc, ck.acc)
    assert back.meta["payoff"] == "vanilla_call"


def test_resume_rejects_changed_market_data(tmp_path):
    """Regression (review finding): resuming under different dynamics or
    step counts must fail loudly, not merge distributions."""
    ck = str(tmp_path / "run.npz")
    chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck, tile_rows=8)
    with pytest.raises(ValueError, match="option"):
        chunked_price(option=OptionParams(sigma=0.3), sim=SIM,
                      chunk_paths=CHUNK, checkpoint_path=ck, resume=True, tile_rows=8)
    with pytest.raises(ValueError, match="n_steps"):
        chunked_price(sim=SimParams(n_paths=SIM.n_paths, n_steps=20),
                      chunk_paths=CHUNK, checkpoint_path=ck, resume=True, tile_rows=8)


def test_engine_typo_rejected(tmp_path):
    """Regression (advisor): a typo'd engine silently fell back to the
    XLA path; it must raise like price() does."""
    with pytest.raises(ValueError, match="engine"):
        chunked_price(sim=SIM, chunk_paths=CHUNK, engine="palas",
                      tile_rows=8)


def test_resume_rejects_changed_rng_source(tmp_path):
    """Regression (review): the stream (round count) is part of the
    resume contract — merging 13- and 20-round chunks must fail loudly."""
    ck = str(tmp_path / "run.npz")
    chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck, tile_rows=8)
    with pytest.raises(ValueError, match="rng_source"):
        chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck,
                      resume=True, tile_rows=8,
                      rng_source="threefry")


def test_hw_rng_source_rejected():
    """Unknown stream names must not silently map to 20-round threefry:
    only the counter-based streams can honor the bit-identical-resume
    contract."""
    with pytest.raises(ValueError, match="rng_source"):
        chunked_price(sim=SIM, chunk_paths=CHUNK, rng_source="hw",
                      tile_rows=8)
    with pytest.raises(ValueError, match="rng_source"):
        chunked_price(sim=SIM, chunk_paths=CHUNK, rng_source="threefry31",
                      tile_rows=8)


def test_elastic_mesh_bitwise_invariance(tmp_path):
    """Elastic restarts (SURVEY section 5): the CHUNK is the atomic unit
    and slabs combine in chunk-index order, so chunked_price is
    bit-identical across ANY mesh size, and a run interrupted on N chips
    resumes on M chips with zero rounding difference."""
    import jax

    from mc_tpu.checkpoint import Checkpoint, load_checkpoint
    from mc_tpu.parallel import make_mesh
    sim = SimParams(n_paths=40_000, n_steps=10)
    ch = 8192
    seq = chunked_price(sim=sim, chunk_paths=ch, tile_rows=8)
    m8 = chunked_price(sim=sim, chunk_paths=ch, tile_rows=8,
                       mesh=make_mesh(jax.devices()[:8]))
    m3 = chunked_price(sim=sim, chunk_paths=ch, tile_rows=8,
                       mesh=make_mesh(jax.devices()[:3]))
    assert float(seq.price) == float(m8.price) == float(m3.price)

    # interruption: checkpoint the EXACT state after chunks 0..1 (a
    # 2-chunk run on the 8-mesh writes it), bump n_paths back to the full
    # target, then resume the remaining chunks on a 3-chip mesh
    ck = str(tmp_path / "elastic.npz")
    chunked_price(sim=SimParams(n_paths=2 * ch, n_steps=10),
                  chunk_paths=ch, tile_rows=8,
                  mesh=make_mesh(jax.devices()[:8]), checkpoint_path=ck)
    mid = load_checkpoint(ck)
    mid.n_paths = sim.n_paths
    mid.save(ck)
    resumed = chunked_price(sim=sim, chunk_paths=ch,
                            tile_rows=8, mesh=make_mesh(jax.devices()[:3]),
                            checkpoint_path=ck, resume=True)
    assert float(resumed.price) == float(seq.price)


def test_elastic_resume_rejects_off_boundary(tmp_path):
    import jax

    from mc_tpu.checkpoint import Checkpoint, load_checkpoint
    from mc_tpu.parallel import make_mesh
    sim = SimParams(n_paths=40_000, n_steps=10)
    ck = str(tmp_path / "off.npz")
    chunked_price(sim=sim, chunk_paths=8192, tile_rows=8,
                  checkpoint_path=ck)
    bad = load_checkpoint(ck)
    bad.paths_done = 5000  # not a chunk boundary
    bad.save(ck)
    with pytest.raises(ValueError, match="chunk boundary"):
        chunked_price(sim=sim, chunk_paths=8192, tile_rows=8,
                      mesh=make_mesh(jax.devices()[:4]),
                      checkpoint_path=ck, resume=True)


# --- chunked_price over model families (round 3) ---------------------------

def test_chunked_model_matches_plain():
    """Family chunked accumulation equals the one-shot price within fp
    noise (heston), exactly (vasicek pathwise discount)."""
    from mc_tpu.models.heston import price_heston
    from mc_tpu.models.vasicek import price_vasicek
    sim = SimParams(n_paths=40_000, n_steps=10)
    a = chunked_price(sim=sim, chunk_paths=CHUNK, model="heston", tile_rows=8)
    b = price_heston(sim=sim, tile_rows=8)
    assert float(a.price) == pytest.approx(float(b.price), rel=1e-6)
    av = chunked_price(sim=sim, chunk_paths=CHUNK, model="vasicek", tile_rows=8)
    bv = price_vasicek(sim=sim, tile_rows=8)
    assert float(av.price) == pytest.approx(float(bv.price), rel=1e-6)


def test_chunked_model_elastic_bitwise(tmp_path):
    """A heston run interrupted on 8 chips resumes on 3 with
    bit-identical totals (the chunk stays the atomic unit under any
    dynamics)."""
    import jax

    from mc_tpu.parallel import make_mesh
    sim = SimParams(n_paths=40_000, n_steps=10)
    ch = 8192
    seq = chunked_price(sim=sim, chunk_paths=ch, model="heston", tile_rows=8)
    m8 = chunked_price(sim=sim, chunk_paths=ch, model="heston", tile_rows=8,
                       mesh=make_mesh(jax.devices()[:8]))
    assert float(seq.price) == float(m8.price)
    ck = str(tmp_path / "model.npz")
    chunked_price(sim=SimParams(n_paths=2 * ch, n_steps=10),
                  chunk_paths=ch, model="heston",
                  tile_rows=8, mesh=make_mesh(jax.devices()[:8]),
                  checkpoint_path=ck)
    mid = load_checkpoint(ck)
    mid.n_paths = sim.n_paths
    mid.save(ck)
    resumed = chunked_price(sim=sim, chunk_paths=ch, model="heston", tile_rows=8,
                            mesh=make_mesh(jax.devices()[:3]),
                            checkpoint_path=ck, resume=True)
    assert float(resumed.price) == float(seq.price)


def test_chunked_model_rejects_changed_dynamics(tmp_path):
    """Resuming under different dynamics merges distributions — must
    fail loudly (dyn fingerprint in the checkpoint meta)."""
    from mc_tpu.models.heston import HestonDynamics
    sim = SimParams(n_paths=2 * CHUNK, n_steps=10)
    ck = str(tmp_path / "dyn.npz")
    chunked_price(sim=sim, chunk_paths=CHUNK, model="heston", tile_rows=8, checkpoint_path=ck)
    with pytest.raises(ValueError, match="mismatch for 'dyn'"):
        chunked_price(sim=sim, chunk_paths=CHUNK, model="heston",
                      dyn=HestonDynamics(v0=0.09),
                      tile_rows=8, checkpoint_path=ck, resume=True)


def test_chunked_model_validation():
    with pytest.raises(ValueError, match="unknown model"):
        chunked_price(model="bachelier")
    with pytest.raises(ValueError, match="terminal-draw"):
        chunked_price(model="rainbow")
    with pytest.raises(ValueError, match="even n_steps"):
        chunked_price(sim=SimParams(n_paths=2048, n_steps=9),
                      model="merton", tile_rows=8)
