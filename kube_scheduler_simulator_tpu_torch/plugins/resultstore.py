"""Result-store message constants the batch annotation writer emits."""

PASSED_FILTER_MESSAGE = "passed"
SUCCESS_MESSAGE = "success"
