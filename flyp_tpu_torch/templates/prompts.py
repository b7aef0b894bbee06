"""The prompt-template sets (public data, preserved verbatim from the
CLIP/FLYP releases — `src/templates/*.py`)."""

from __future__ import annotations

from .registry import append_proper_article, fmt, register_template

__all__ = [
    "openai_imagenet_template",
    "openai_imagenet_template_reduced",
    "simple_template",
    "fmow_template",
    "iwildcam_template",
    "caltech101_template",
    "country211_template",
    "stanfordcars_template",
    "flowers102_template",
    "eurosat_template",
    "sun397_template",
    "patchcamelyon_template",
    "sst2_template",
    "hatefulmemes_template",
]

_OPENAI_IMAGENET_PROMPTS = [
    "a bad photo of a {}.", "a photo of many {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.", "the embroidered {}.",
    "a photo of a hard to see {}.", "a bright photo of a {}.",
    "a photo of a clean {}.", "a photo of a dirty {}.",
    "a dark photo of the {}.", "a drawing of a {}.", "a photo of my {}.",
    "the plastic {}.", "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.", "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.", "a blurry photo of the {}.",
    "a photo of the {}.", "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.", "the origami {}.",
    "the {} in a video game.", "a sketch of a {}.", "a doodle of the {}.",
    "a origami {}.", "a low resolution photo of a {}.", "the toy {}.",
    "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.", "a photo of a nice {}.",
    "a photo of a weird {}.", "a blurry photo of a {}.", "a cartoon {}.",
    "art of a {}.", "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.", "a photo of the small {}.",
    "a photo of the weird {}.", "the cartoon {}.", "art of the {}.",
    "a drawing of the {}.", "a photo of the large {}.",
    "a black and white photo of a {}.", "the plushie {}.",
    "a dark photo of a {}.", "itap of a {}.", "graffiti of the {}.",
    "a toy {}.", "itap of my {}.", "a photo of a cool {}.",
    "a photo of a small {}.", "a tattoo of the {}.",
]

openai_imagenet_template = register_template(
    "openai_imagenet_template", [fmt(p) for p in _OPENAI_IMAGENET_PROMPTS]
)

openai_imagenet_template_reduced = register_template(
    "openai_imagenet_template_reduced",
    [fmt(p) for p in [
        "a photo of many {}.", "a sculpture of a {}.", "a sketch of a {}.",
        "a good photo of the {}.", "a {} in a video game.",
    ]],
)

simple_template = register_template("simple_template", [fmt("a photo of a {}.")])

fmow_template = register_template(
    "fmow_template",
    [
        fmt("satellite photo of a {}."),
        fmt("aerial photo of a {}."),
        lambda c: f"satellite photo of {append_proper_article(c)}.",
        lambda c: f"aerial photo of {append_proper_article(c)}.",
        fmt("satellite photo of a {} in asia."),
        fmt("aerial photo of a {} in asia."),
        fmt("satellite photo of a {} in africa."),
        fmt("aerial photo of a {} in africa."),
        fmt("satellite photo of a {} in the americas."),
        fmt("aerial photo of a {} in the americas."),
        fmt("satellite photo of a {} in europe."),
        fmt("aerial photo of a {} in europe."),
        fmt("satellite photo of a {} in oceania."),
        fmt("aerial photo of a {} in oceania."),
        fmt("a photo of a {}."),
        fmt("{}."),
    ],
)

iwildcam_template = register_template(
    "iwildcam_template", [fmt("a photo of {}."), fmt("{} in the wild.")]
)

caltech101_template = register_template(
    "caltech101_template",
    [fmt(p) for p in [
        "a photo of a {}.", "a painting of a {}.", "a plastic {}.",
        "a sculpture of a {}.", "a sketch of a {}.", "a tattoo of a {}.",
        "a toy {}.", "a rendition of a {}.", "a embroidered {}.",
        "a cartoon {}.", "a {} in a video game.", "a plushie {}.",
        "a origami {}.", "art of a {}.", "graffiti of a {}.",
        "a drawing of a {}.", "a doodle of a {}.", "a photo of the {}.",
        "a painting of the {}.", "the plastic {}.", "a sculpture of the {}.",
        "a sketch of the {}.", "a tattoo of the {}.", "the toy {}.",
        "a rendition of the {}.", "the embroidered {}.", "the cartoon {}.",
        "the {} in a video game.", "the plushie {}.", "the origami {}.",
        "art of the {}.", "graffiti of the {}.", "a drawing of the {}.",
        "a doodle of the {}.",
    ]],
)

country211_template = register_template(
    "country211_template",
    [fmt(p) for p in [
        "a photo i took in {}.", "a photo i took while visiting {}.",
        "a photo from my home country of {}.", "a photo from my visit to {}.",
        "a photo showing the country of {}.",
    ]],
)

stanfordcars_template = register_template(
    "stanfordcars_template",
    [fmt(p) for p in [
        "a photo of a {}.", "a photo of the {}.", "a photo of my {}.",
        "i love my {}!", "a photo of my dirty {}.", "a photo of my clean {}.",
        "a photo of my new {}.", "a photo of my old {}.",
    ]],
)

flowers102_template = register_template(
    "flowers102_template", [fmt("a photo of a {}, a type of flower.")]
)

eurosat_template = register_template(
    "eurosat_template",
    [fmt(p) for p in [
        "a centered satellite photo of {}.",
        "a centered satellite photo of a {}.",
        "a centered satellite photo of the {}.",
    ]],
)

sun397_template = register_template(
    "sun397_template", [fmt("a photo of a {}."), fmt("a photo of the {}.")]
)

patchcamelyon_template = register_template(
    "patchcamelyon_template", [fmt("this is a photo of {}")]
)

sst2_template = register_template("sst2_template", [fmt("a {} review of a movie.")])

hatefulmemes_template = register_template("hatefulmemes_template", [fmt("a {}.")])
