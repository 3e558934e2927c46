"""The frozen reference against the port's plain CPU path: the only test
that imports the port."""

import numpy as np
import pytest
import torch

from portbench import compare
from portbench.reference.render import render


@pytest.mark.parametrize("exact", [False, True], ids=["q32", "kcar"])
def test_reference_matches_the_port_batch(exact):
    from grail_tpu_torch import api

    texts = ["hello there", "your order"]
    torch.set_num_threads(2)
    prog = api.synthesize_batch(texts, voice="plain", language="english",
                                seeds=[5, 9], device="cpu",
                                exact_carrier="kernel" if exact else False)
    refs = render(texts, [5, 9], "plain", "english", exact, "cpu")
    for p, r in zip(prog, refs):
        assert compare.gap(p.numpy(), r) < 1e-5


def test_reference_matches_the_port_session():
    from grail_tpu_torch.runtime.stream import StreamPool

    text = "now."
    pool = StreamPool(1, voice="plain", language="english", block=128,
                      seeds=[77], device="cpu")
    pool.feed(0, text)
    pool.flush(0)
    n_blocks = 60
    got = np.concatenate([np.asarray(pool.read_block())[0]
                          for _ in range(n_blocks)])
    (ref, n), = render([text], [77], "plain", "english", True, "cpu",
                       stop=n_blocks * 128, lengths=True)
    e = min(n, len(got))
    assert compare.gap(got[:e], ref[:e]) < 1e-5
