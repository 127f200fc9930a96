"""Family NMC over every registered model family: the outer grids the
engine resumes from, path-dependent payoff state, and the 1-device mesh
(the C9/C10 relationship of the reference, inc/nmc.cuh)."""

import jax
import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.nmc_engine import NMC_FAMILY_BUILDERS, price_nmc_family

# importing the family modules populates the registry
import mc_tpu.nmc_basket  # noqa: F401
import mc_tpu.nmc_cev  # noqa: F401
import mc_tpu.nmc_heston  # noqa: F401
import mc_tpu.nmc_localvol  # noqa: F401
import mc_tpu.nmc_merton  # noqa: F401
import mc_tpu.nmc_rainbow  # noqa: F401
import mc_tpu.nmc_sabr  # noqa: F401
import mc_tpu.nmc_term  # noqa: F401
import mc_tpu.nmc_vasicek  # noqa: F401

OPT = OptionParams()
SIM = SimParams(n_paths=512, n_steps=4, n_paths_inner=8)

FAMILIES = sorted(NMC_FAMILY_BUILDERS)


@pytest.mark.parametrize("model", FAMILIES)
def test_surface_rides_the_outer_grids(model):
    """The family engine's outer pass is the family's trajectory
    materialization: its spot grid and outer moments are exactly what
    `NMCFamily.trajectories` builds from the same key (the C9 grids the
    LSMC clients consume)."""
    from mc_tpu.nmc_engine import _validate_and_keys
    from mc_tpu.ops import path_kernels as pk
    from mc_tpu.ops.payoffs import get_payoff

    fam, dyn32 = NMC_FAMILY_BUILDERS[model](OPT, None, SIM)
    res = price_nmc_family(fam, OPT, dyn32, SIM, "vanilla_call")
    _, key_outer, _ = _validate_and_keys(fam, SIM, "vanilla_call", 0, 1)
    cfg = pk.KernelConfig(n_paths=SIM.n_paths, n_steps=SIM.n_steps,
                          tile_rows=8)
    params = fam.pack(OPT.as_f32(), dyn32, SIM.n_steps)
    *grids, _, _ = fam.trajectories(get_payoff("vanilla_call"), cfg,
                                    key_outer, params)
    # Same simulation; the two programs may contract a multiply-add
    # differently (XLA fuses each in its own context): a few ulps.
    np.testing.assert_allclose(np.asarray(res.spot_surface),
                               np.asarray(grids[0]), rtol=2e-6)
    assert res.surface.shape == grids[0].shape
    assert np.isfinite(np.asarray(res.surface)).all()


@pytest.mark.parametrize("model", ("heston", "basket"))
def test_path_payoff_state_resumes(model):
    """Path-dependent payoff state (running average) rides the outer
    carry into every inner leg: the last step's surface is the payoff of
    the stored state itself (no steps remain), discounted."""
    fam, dyn32 = NMC_FAMILY_BUILDERS[model](OPT, None, SIM)
    res = price_nmc_family(fam, OPT, dyn32, SIM, "asian_call")
    last = np.asarray(res.surface_matrix())[:, -1]
    assert np.isfinite(last).all() and (last >= 0.0).all()
    assert float(res.outer.price) > 0.0


def test_sharded_term_model_runs():
    """'term' joined _NMC_MODEL_MODULES late: 1-device mesh is bitwise
    the single-device result, like every other family."""
    from mc_tpu.nmc_term import price_nmc_term
    from mc_tpu.parallel import make_mesh, price_nmc_model_sharded

    single = price_nmc_term(sim=SIM)
    m1 = price_nmc_model_sharded("term", sim=SIM,
                                 mesh=make_mesh(jax.devices()[:1]))
    assert float(m1.outer.price) == float(single.outer.price)
    np.testing.assert_array_equal(np.asarray(m1.surface),
                                  np.asarray(single.surface))
