"""Local row-level scoring (counterpart of local/, reference local module):
one fitted workflow scores as a plain ``dict -> dict`` function, replayed
record by record on the CPU — see `scoring.score_function`."""
from .scoring import ScoreFunction, score_function

__all__ = ["ScoreFunction", "score_function"]
