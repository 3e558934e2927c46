"""The text generator: deterministic by seed, the stated lengths."""

import numpy as np

from portbench.traffic import generator as g


def test_batches_deterministic_by_seed():
    mix = g.load_mix("sentences")
    a = g.batches(mix, 2 ** 33 + 7, 3)
    assert a == g.batches(mix, 2 ** 33 + 7, 3)
    assert a != g.batches(mix, 2 ** 33 + 8, 3)
    assert all(len(b) == 64 for b in a)


def test_sentence_lengths_match_the_stated_distribution():
    mix = g.load_mix("sentences")
    c64 = g.quantile_counts(mix["words"], 64)
    assert abs(np.mean(c64) - 17.2) < 0.3
    c = g.quantile_counts(mix["words"], 4096)
    assert abs(np.mean(c) - 17.2) < 0.1
    assert 2 <= min(c) <= 3 and max(c) == 38     # clipped to 2..38
    # every batch holds the same word counts, in another order
    for b in g.batches(mix, 5, 3):
        assert sorted(len(t.split()) for t in b) == sorted(c64)
    # ~100 characters a text, as LJSpeech's clips
    assert 95 < g.mean_chars(mix) < 105
    texts = [t for b in g.batches(mix, 9, 20) for t in b]
    assert 90 < np.mean([len(t) for t in texts]) < 110


def test_prompts_are_one_to_six_words():
    mix = g.load_mix("prompts")
    c = g.quantile_counts(mix["words"], 64)
    assert min(c) == 1 and max(c) == 6 and np.mean(c) == 3.5

