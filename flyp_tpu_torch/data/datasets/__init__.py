"""The evaluation and training suites of the FLYP protocol.

Counterpart of ``flyp_tpu/data/datasets``.  Every class follows the
harness protocol of ``flyp_tpu_torch.evaluation.evaluator``:
``classnames``, ``test_loader`` (dict batches), optional ``train_loader`` and
the hook methods (``project_logits``, ``project_labels``, ``accuracy``,
``post_loop_metrics``).
"""

from .base import ImageFolderDataset, VisionDataset
from .imagenet import (
    ImageNet,
    ImageNetTrain,
    ImageNetK,
    ImageNetKShot,
    ImageNetSubsample,
    ImageNetSubsampleValClasses,
    IMAGENET_K_CLASSES,
)
from .imagenet_shifts import (
    ImageNetV2,
    ImageNetR,
    ImageNetRValClasses,
    ImageNetA,
    ImageNetAValClasses,
    ImageNetSketch,
)
from .objectnet import ObjectNet, ObjectNetValClasses
from .vid_robust import ImageNetVidRobust, ImageNetVidRobustValClasses
from .wilds_sets import (
    IWildCam,
    IWildCamID,
    IWildCamIDVal,
    IWildCamOOD,
    IWildCamNonEmpty,
    IWildCamIDNonEmpty,
    IWildCamOODNonEmpty,
    FMOW,
    FMOWID,
    FMOWIDVal,
    FMOWOOD,
)
from .transfer import (
    Caltech101Train,
    Caltech101Val,
    Caltech101Test,
    StanfordCarsTrain,
    StanfordCarsVal,
    StanfordCarsTest,
    Flowers102Train,
    Flowers102Val,
    Flowers102Test,
    PatchCamelyonTrain,
    PatchCamelyonVal,
    PatchCamelyonTest,
    SST2Train,
    SST2Val,
    SST2Test,
    OxfordPet,
    OxfordPetVal,
    OxfordPetTest,
)

# The ImageNet{k} few-shot classes, made at import.
globals().update(IMAGENET_K_CLASSES)
