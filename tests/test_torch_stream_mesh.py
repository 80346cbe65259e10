"""``Trainer.fit_stream`` under a mesh: DeepFM on four gloo ranks of the CPU
(``tests/torch_mesh_ranks.py``), per batch and with ``steps_per_call=8``,
fused and plain, against the port's single-device ``fit_stream`` and the
JAX package's mesh ``fit_stream`` on four of its CPU devices. As in the
JAX package, a mesh streams a batch at a time whatever ``steps_per_call``
is, so ``max_steps`` stops at the step and not at a group's end."""
import functools

import numpy as np
import pytest

import jax
import optax

import torch_mesh_ranks as ranks_lib
from recommender_system_tpu.models import DeepFM as JDeepFM
from recommender_system_tpu.parallel.mesh import make_mesh as j_make_mesh
from recommender_system_tpu.training import FusedAdagrad as JFusedAdagrad
from recommender_system_tpu.training import Trainer as JTrainer
from recommender_system_tpu.utils.datasets import synthetic_criteo as j_synthetic_criteo
from recommender_system_tpu_torch.convert import load_jax_opt_state
from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

N_RANKS = ranks_lib.WORLD
LR, HIDDEN, VOCAB, BATCH, N_BATCHES = 0.05, (32, 16), 64, 64, 10
# the tolerances of tests/test_torch_fused_mesh.py: the JAX fused kernels
# round every cotangent to bf16; f32 elsewhere, summed in another order
BF16 = dict(rtol=1e-2, atol=2e-4)
F32_JAX_MESH = dict(rtol=1e-4, atol=1e-5)
F32 = dict(rtol=1e-4, atol=1e-6)

# case -> (fused, steps_per_call, max_steps)
CASES = {
    "per_batch_fused": (True, 1, 0),
    "per_batch_plain": (False, 1, 0),
    "packed_fused": (True, 8, 0),
    "packed_plain": (False, 8, 0),
    "packed_fused_max_steps": (True, 8, 5),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = ranks_lib.RankPool(N_RANKS, tmp_path_factory.mktemp("gloo"))
    yield pool
    pool.close()


@functools.lru_cache(maxsize=None)
def _data():
    """Ten batches of 64 rows (16 a rank): one group of 8 and a tail of 2."""
    jcols, X, y = j_synthetic_criteo(n_rows=BATCH * N_BATCHES, vocab=VOCAB, embedding_dim=8,
                                     seed=0)
    tcols = synthetic_criteo(n_rows=8, vocab=VOCAB, embedding_dim=8, seed=0)[0]
    batches = [({k: v[i * BATCH:(i + 1) * BATCH] for k, v in X.items()},
                y[i * BATCH:(i + 1) * BATCH]) for i in range(N_BATCHES)]
    return jcols, tcols, batches


def _spec(tcols, fused):
    spec = {"columns": tcols, "hidden": HIDDEN, "optimizer": ("adagrad", LR)}
    if fused:
        spec["fused"] = ("adagrad", LR)
    return spec


@functools.lru_cache(maxsize=None)
def _jax_stream(fused, steps_per_call, max_steps):
    """The JAX mesh Trainer's ``fit_stream``: its start, end state and
    history."""
    jcols, _, batches = _data()
    trainer = JTrainer(JDeepFM(tuple(jcols), hidden_units=HIDDEN),
                       optimizer=optax.adagrad(LR), seed=3,
                       fused_embedding=JFusedAdagrad(LR) if fused else None,
                       mesh=j_make_mesh(data=N_RANKS, model=1), capacity_factor=8.0)
    state = trainer.init(batches[0][0])
    params = jax.tree_util.tree_map(np.asarray, state.params)
    state, history = trainer.fit_stream(state, iter(batches), steps_per_call=steps_per_call,
                                        max_steps=max_steps)
    return params, state, history


def _assert_views_close(got, want, tol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_fit_stream_follows_single_device_and_jax_mesh(ranks, case):
    fused, steps_per_call, max_steps = CASES[case]
    _, tcols, batches = _data()
    params, j_state, j_history = _jax_stream(fused, steps_per_call, max_steps)
    spec = _spec(tcols, fused)
    stream_kw = dict(steps_per_call=steps_per_call, max_steps=max_steps)
    got = ranks.run(ranks_lib.fit_stream_on_mesh, "deepfm", spec, params, batches,
                    dict(capacity_factor=8.0), stream_kw)[0]
    steps = max_steps or N_BATCHES
    assert got["step"] == int(j_state.step) == steps
    np.testing.assert_allclose(got["history"]["loss"], j_history["loss"], rtol=2e-4)
    if fused:
        assert got["history"]["embedding_overflow"] == j_history["embedding_overflow"] == [0]
    want = ranks_lib.build_trainer("deepfm", spec, jax.tree_util.tree_map(
        np.asarray, j_state.params))
    load_jax_opt_state(want, j_state.opt_state, step=int(j_state.step))
    _assert_views_close(got["view"], ranks_lib.view(want), BF16 if fused else F32_JAX_MESH)

    # the single device streams the same batches; packed, it stops only at
    # a group's end (as the JAX package's single device does), past the
    # mesh's step
    single = ranks_lib.build_trainer("deepfm", spec, params)
    history = single.fit_stream(iter(batches), steps_per_call=steps_per_call,
                                max_steps=max_steps)
    if steps_per_call > 1 and max_steps:
        assert single.step > got["step"]
        return
    assert single.step == got["step"]
    np.testing.assert_allclose(got["history"]["loss"], history["loss"], **F32)
    _assert_views_close(got["view"], ranks_lib.view(single), F32)
