"""Host data pipeline of the port (copies of `cape_tpu.data`): tokenizer,
MP-100 dataset, episodic batches, prefetch, the synthetic fixture and the
image routes (`data.image`)."""

from .token_types import TokenType
from .tokenizer import DiscreteTokenizer, tokenize_keypoints

__all__ = ["TokenType", "DiscreteTokenizer", "tokenize_keypoints"]
