"""The port's ``SyntheticTokens`` draws its unigram tokens from a cdf
built once (``searchsorted``) where the reference calls
``Generator.choice(p=...)`` at every position: the token streams stay
bitwise the reference's, at smoke vocabularies and at the published
ones of the archs the trainers feed above 8192 tokens."""
import numpy as np
import pytest

from repro.data.synthetic import SyntheticTokens as JSyntheticTokens
from repro_torch.data.synthetic import SyntheticTokens


@pytest.mark.parametrize("vocab,b,s,seed", [
    (2, 4, 50, 0),
    (512, 8, 128, 3),
    (50280, 2, 40, 1),
    (102400, 2, 40, 0),
    (256000, 1, 60, 0),
])
def test_tokens_are_the_references(vocab, b, s, seed):
    mine = SyntheticTokens(vocab, b, s, seed=seed)
    theirs = JSyntheticTokens(vocab, b, s, seed=seed)
    for _ in range(3):
        np.testing.assert_array_equal(
            mine.next_batch()["tokens"].numpy(),
            np.asarray(theirs.next_batch()["tokens"]))


def test_unigram_draw_is_generator_choice():
    data = SyntheticTokens(1000, 1, 1, seed=5)
    rng = np.random.default_rng(6)
    for n in (1, 7, 4096):
        want = rng.choice(1000, size=n, p=data._unigram)
        np.testing.assert_array_equal(data._unigram_draw(n), want)
