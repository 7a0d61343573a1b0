"""Token-type ids for keypoint sequence generation.

Parity with the reference enum (`datasets/token_types.py:5-12`): the class
head predicts one of {coord, sep, eos} per step (cls exists only for the
legacy floorplan path and is never used for CAPE).
"""

from enum import IntEnum


class TokenType(IntEnum):
    coord = 0
    sep = 1
    eos = 2
    cls = 3
