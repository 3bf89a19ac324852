__version__ = "0.1.0"

# Version string of the reference implementation whose behaviour this
# framework reproduces (reference version.h:48).
REFERENCE_VERSION = "AGREP 3.41.5/TG"
