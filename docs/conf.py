"""Sphinx configuration for mind_the_gaps_tpu.

Deliverable parity with the reference's Sphinx+MyST+autoapi docs build
(reference docs/conf.py, pyproject.toml:42-50); the build itself runs in
CI (.github/workflows/docs.yml), since the development image does not
ship sphinx.
"""
import os
import sys

sys.path.insert(0, os.path.abspath(".."))

project = "mind_the_gaps_tpu"
author = "mind_the_gaps_tpu developers"
release = "1.0"
version = "1.0"

extensions = [
    "autoapi.extension",
    "sphinx.ext.napoleon",
    "sphinx.ext.mathjax",
    "sphinx.ext.viewcode",
]

# myst_nb renders the executed tutorial notebooks (docs/notebooks/,
# generated by docs/make_notebooks.py); it bundles the myst markdown
# parser, so only fall back to bare myst_parser without it
try:
    import myst_nb  # noqa: F401

    extensions.insert(0, "myst_nb")
    nb_execution_mode = "off"  # notebooks are committed pre-executed
except ImportError:
    extensions.insert(0, "myst_parser")

autoapi_dirs = ["../mind_the_gaps_tpu"]
autoapi_type = "python"
autoapi_ignore = ["*_fastio*"]
autoapi_options = [
    "members",
    "undoc-members",
    "show-inheritance",
    "show-module-summary",
]

myst_enable_extensions = ["dollarmath", "colon_fence"]

source_suffix = {".rst": "restructuredtext", ".md": "markdown"}
master_doc = "index"
exclude_patterns = ["_build"]

html_theme = "sphinx_rtd_theme"
