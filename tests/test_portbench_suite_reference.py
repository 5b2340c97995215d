"""The benchmark's own tests in this suite: from
``portbench/tests/test_portbench_reference.py``, each cell's harness run on
the CPU at its small mix comes out correct and its float32 control does not
(its faults are ``test_portbench_suite_faults.py``). One module a file of
``portbench/tests``, that file in two, so that the suite's workers, which
take a module each, spread them; each test on one torch thread
(``tests/portbench_suite.py``)."""

from tests.portbench_suite import one_torch_thread  # noqa: F401

from portbench.tests.test_portbench_reference import (  # noqa: F401
    test_control_fails_a_limit,
    test_small_mixes_cover_every_cell,
    test_sound_run_is_correct,
)
