"""The kernels' wrappers and their plain versions. Importing the package
registers the kernels' custom operators (``library.py``)."""
from . import library  # noqa: F401
