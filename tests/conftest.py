import os
import sys

# Tests run on a virtual 8-device CPU mesh: sharding/collective code paths
# compile and execute without an accelerator.  The platform is pinned
# through jax.config before any backend initializes, so a machine with
# a GPU still runs the suite on the CPU.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["KREEQ_TPU_NO_COMPILE_CACHE"] = "1"  # cache writes slow CPU tests
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(os.path.join(REFERENCE, "validateFiles"))
