"""The benchmark's own tests in this suite:
``portbench/tests/test_portbench_work.py`` (the yardstick's arithmetic, the
readers on made-up traces, the recorded work and launch counts). One module
a file of ``portbench/tests``, so that the suite's workers, which take a
module each, spread them; each test on one torch thread
(``tests/portbench_suite.py``)."""

from tests.portbench_suite import one_torch_thread  # noqa: F401

from portbench.tests.test_portbench_work import *  # noqa: F401,F403
