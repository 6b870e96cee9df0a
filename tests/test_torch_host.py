"""The port's host pipeline against the JAX package's CPU pipeline on a
small simulated ONT set: the same breaking points per overlap and the
same windows (backbone, layers, qualities, positions, window type)
after ``Polisher.initialize()``."""

import numpy as np
import pytest

from racon_tpu.core import polisher as jax_polisher
from racon_tpu.tools import simulate
from racon_tpu_torch.core import polisher as port_polisher


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("host_sim")
    return simulate.simulate(str(out), genome_len=20_000, coverage=10,
                             read_len=2_000, seed=11, ont=True)


def _initialize(module, paths, **kw):
    """Run initialize(), recording each overlap's breaking points
    before _build_windows consumes them."""
    pol = module.create_polisher(*paths, module.PolisherType.kC, 500,
                                 10.0, 0.3, True, 5, -4, -8, 4, **kw)
    points = []
    build = pol._build_windows

    def record(targets_size, window_type, overlaps):
        points.extend((o.q_id, o.t_id, None if o.breaking_points is None
                       else np.array(o.breaking_points))
                      for o in overlaps)
        return build(targets_size, window_type, overlaps)

    pol._build_windows = record
    pol.initialize()
    return pol, points


@pytest.fixture(scope="module")
def both(dataset):
    jax_pol, jax_points = _initialize(jax_polisher, dataset)
    port_pol, port_points = _initialize(port_polisher, dataset)
    yield jax_pol, jax_points, port_pol, port_points
    jax_pol.close()
    port_pol.close()


def test_breaking_points_equal(both):
    _, jax_points, _, port_points = both
    assert len(port_points) == len(jax_points) > 0
    for (jq, jt, jp), (pq, pt, pp) in zip(jax_points, port_points):
        assert (jq, jt) == (pq, pt)
        assert np.array_equal(jp, pp)


def test_windows_equal(both):
    jax_pol, _, port_pol, _ = both
    assert len(port_pol.windows) == len(jax_pol.windows) > 0
    assert sum(len(w.sequences) >= 3 for w in port_pol.windows) > 0
    for jw, pw in zip(jax_pol.windows, port_pol.windows):
        assert (pw.id, pw.rank, pw.type.value) == \
            (jw.id, jw.rank, jw.type.value)
        assert pw.sequences == jw.sequences
        assert pw.qualities == jw.qualities
        assert pw.positions == jw.positions


def test_coverages_and_window_type(both):
    jax_pol, _, port_pol, _ = both
    assert port_pol.targets_coverages == jax_pol.targets_coverages
    assert port_pol.window_type.value == jax_pol.window_type.value
