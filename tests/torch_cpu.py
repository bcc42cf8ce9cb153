"""CPU set-up shared by the PyTorch port's tests.

On the CPU build of torch the tests run with, the first ``exp`` of a
process, with torch at its default thread count, now and then returns
values a few ulp off what every later call returns.  Measured on
``gn_mish_mask_ref`` at ``test_torch_ops.py::test_gn_mish_ref_matches_jax_f32``'s
first shape, in fresh pytest processes started eight at a time with JAX
imported first, as the parallel test run starts its workers:

- default threads: in 5 of 24 processes the first call's ``exp`` differed
  from the second call's (up to 0.27 at values near 1.6e5), the output by
  3.6e-5 to 3.8e-5, over that test's 3e-5 bar; every later call agreed with
  the second, and with JAX to 2.9e-6.  Mean, variance and the normalised
  input agreed exactly in every process.
- ``torch.set_num_threads(1)`` first: no difference in 32 processes.
- one ``exp`` on a throwaway tensor first (this fixture): no difference in
  32 processes.

So each port test module takes this fixture, which makes that first call
before its tests run.  The modules import it by its bare name (pytest puts
``tests/`` on the path), so it also loads where another ``tests`` package
is installed.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def torch_threads_started():
    torch.exp(torch.zeros(1 << 20))
