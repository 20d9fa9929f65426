"""The benchmark's gnu yardstick held to the reference server, in the
repository's own test run.

`dsmbench/test_dsmbench.py` holds the plain reference's gnu reader order
(dsmbench/reference.py) to the 24 frozen server outputs of
`tests/golden` byte for byte, per prefix and over the whole trie, and
its set model to a real libstdc++ `unordered_set` at 5, 64 and 273
readers.  `pytest tests/` does not collect that file; these are its
tests and their fixtures, imported unchanged.
"""

import pytest
import torch

from dsmbench.test_dsmbench import (  # noqa: F401
    test_gnu_reference_prints_the_servers_bytes,
    test_gnu_whole_trie_is_the_four_servers,
    test_gnuset_is_libstdcxx_unordered_set, toy_index, uset_oracle)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the reference's many small CPU ops: the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
