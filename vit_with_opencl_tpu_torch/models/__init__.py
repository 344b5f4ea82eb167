from .golden import golden_features, golden_forward  # noqa: F401
