"""The benchmark's own tests in this suite: from
``portbench/tests/test_portbench_reference.py``, each cell's harness run on
the CPU at its small mix comes out not correct under each fault of its flow
(its sound runs are ``test_portbench_suite_reference.py``). One module a
file of ``portbench/tests``, that file in two, so that the suite's workers,
which take a module each, spread them; each test on one torch thread
(``tests/portbench_suite.py``)."""

from tests.portbench_suite import one_torch_thread  # noqa: F401

from portbench.tests.test_portbench_reference import test_broken_timed_path_is_not_correct  # noqa: F401
