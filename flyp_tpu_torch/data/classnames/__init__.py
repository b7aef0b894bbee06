"""Class-name and class-index data assets (public data from the FLYP/CLIP
releases; see each module's docstring for provenance)."""

from .imagenet import get_classnames, openai_classnames
from .imagenet_sublists import IMAGENET_A_SUBLIST, IMAGENET_R_SUBLIST
from .caltech101 import caltech101_classnames
from .stanfordcars import stanfordcars_classnames
from .fmow import fmow_classnames
from .flowers102 import flowers102_classnames
from .binary_tasks import patchcamelyon_classnames, sst2_classnames
