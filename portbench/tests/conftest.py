import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops on several threads under the suite's parallel workers
    run far slower than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

