from smatcher.core.alphabet import Alphabet
from smatcher.core.patterns import PatternSet
from smatcher.core import datagen
from smatcher.core import corpus

__all__ = ["Alphabet", "PatternSet", "datagen", "corpus"]
