"""Discrete coordinate tokenizer: the vocabulary layout and special ids.

Copy of `cape_tpu.data.tokenizer.DiscreteTokenizer` (the port imports
nothing of `cape_tpu`). Vocab layout: `num_bins^2` grid cells, then
BOS/EOS/SEP/PAD specials (`datasets/discrete_tokenizer.py:20-28`); the
flattened 2D index is `x_idx * num_bins + y_idx` (x-major,
`mp100_cape.py:709-713`). The serving path re-tokenizes on the device
(`models/cape.autoregressive_decode`), so only the special ids are kept;
the host-side quantization and `tokenize_keypoints` wait for the training
slice.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DiscreteTokenizer:
    """Vocabulary layout + special token ids.

    `num_bins` bins per axis; grid-cell ids occupy [0, num_bins^2) and the
    four specials follow (`discrete_tokenizer.py:16-28`, add_cls is never
    used for CAPE).
    """

    num_bins: int
    seq_len: int

    @property
    def bos(self) -> int:
        return self.num_bins * self.num_bins + 0

    @property
    def eos(self) -> int:
        return self.num_bins * self.num_bins + 1

    @property
    def sep(self) -> int:
        return self.num_bins * self.num_bins + 2

    @property
    def pad(self) -> int:
        return self.num_bins * self.num_bins + 3

    @property
    def vocab_size(self) -> int:
        return self.num_bins * self.num_bins + 4

    def __len__(self) -> int:
        return self.vocab_size
