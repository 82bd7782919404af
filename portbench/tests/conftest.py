import pytest


@pytest.fixture
def card():
    """Skips a test marked ``cuda`` where torch sees no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
