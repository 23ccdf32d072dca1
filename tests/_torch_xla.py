"""The JAX references of a port test file, compiled by XLA:CPU without
most of its optimization passes.

A test file imports the fixture, which then runs once for the file:

    from _torch_xla import quick_xla  # noqa: F401

Most of the port files' time is XLA compiling the JAX references (the
eager references compile one program an op); without the optimization
passes the files take about 40% less time. The setting is restored after
the file, so the JAX package's own tests keep XLA's defaults. A file whose
reference rounds differently without the passes, so that a comparison
moves past its tolerance, does not import it."""

import jax
import pytest


@pytest.fixture(autouse=True, scope='module')
def quick_xla():
    before = jax.config.values['jax_disable_most_optimizations']
    jax.config.update('jax_disable_most_optimizations', True)
    yield
    jax.config.update('jax_disable_most_optimizations', before)
