"""Models of the port: the Xception tile classifier and its presets (the
ResNet family in ``resnet.py``), and the weight bridge (``convert.py``)."""

from .xception import (  # noqa: F401
    ARCHS,
    Head,
    XceptionBackbone,
    XceptionClassifier,
    build_model,
    feature_dim,
)
