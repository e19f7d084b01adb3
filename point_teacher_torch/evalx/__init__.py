from .cocoeval import AITOD_AREA_RNGS, COCOStyleEval, aitod_evaluate  # noqa: F401
