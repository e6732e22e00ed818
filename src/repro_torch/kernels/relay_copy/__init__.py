from .ref import relay_assemble_ref
from .relay_copy import relay_assemble
