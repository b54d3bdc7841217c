"""One torch thread for every test of the PyTorch port: the suite runs one
worker process per core, and torch's intra-op pool on top of that
oversubscribes the cores.  Each ``tests/test_torch_*.py`` file imports
``one_torch_thread``, which makes it an autouse fixture of that module."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
