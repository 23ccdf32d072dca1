"""The port's ensembles on a 2 x 2 ('ensemble', 'data') mesh, both dims
above 1, against the JAX package on 4 CPU devices: four torch-only ranks
(`tests/_torch_dp_serving_worker.py` at world 4) over a gloo group, on the
pattern of tests/test_torch_distributed_serving.py, whose references and
checks this file reuses. Each member pair is served and trained by the two
ranks of its 'ensemble' coordinate, each on half the batch, so that the
members' gather over the 'ensemble' dim and the average over the 'data'
dim run together: three steps without the bootstrap and `predict_ensemble`,
at tests/test_torch_ensemble.py's tolerances.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dp_worker as harness  # noqa: E402
import _torch_dp_serving_worker as worker  # noqa: E402
import test_torch_distributed_serving as serving  # noqa: E402
from _torch_xla import quick_xla  # noqa: E402,F401

WORLD = 4
WORKER_TIMEOUT = 300       # seconds for all ranks
NAME = 'ensemble_2x2'


@pytest.fixture(autouse=True, scope='module')
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    path = tmp_path_factory.mktemp('dp_ensemble_2x2') / 'refs.npz'
    np.savez(path, unused=np.zeros(1))
    return path, serving.ensemble_refs(worker.MESHES_2D)


@pytest.fixture(scope='module')
def ranks(refs):
    return harness.spawn(worker.__file__, refs[0], WORLD, WORKER_TIMEOUT)


def test_ranks_import_neither_jax_nor_the_jax_package(ranks):
    for status, _ in ranks:
        assert status['no_jax'] == []


def test_ensemble_over_the_2x2_mesh_matches_jax(refs, ranks):
    """Every rank's members, the gathered losses of all M members and the
    served member stack against JAX's on its 2 x 2 mesh; the ranks agree
    bit for bit on the losses and the served stack."""
    res = harness.case_results(ranks, 'case_ensembles_2d')
    serving.check_ensemble(res, refs[1], NAME, worker.MESHES_2D[NAME][0][0])


def test_the_data_dim_s_ranks_hold_the_same_members(ranks):
    """Ranks (e, 0) and (e, 1) of the row-major mesh hold members
    [2e, 2e + 2) and end the steps with the same bits, the averaged
    gradients being one update; the two coordinates hold different
    members."""
    res = harness.case_results(ranks, 'case_ensembles_2d')
    keys = [k for k in res[0] if k.startswith(f'{NAME}/end/')]
    assert keys
    for e in range(2):
        a, b = res[2 * e], res[2 * e + 1]
        assert a[f'{NAME}/members'].tolist() == [2 * e, 2 * e + 1]
        np.testing.assert_array_equal(a[f'{NAME}/members'],
                                      b[f'{NAME}/members'])
        for k in keys:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
