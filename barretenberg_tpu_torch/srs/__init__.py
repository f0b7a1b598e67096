from .reference_string import ReferenceString, test_srs  # noqa: F401
