"""Wait for a freshly started DCP server before anything attaches to it.

``python -m dynamo_tpu_torch.runtime.dcp_server`` prints ``dcp listening
on HOST:PORT`` once its socket accepts connections; a test that starts
it as a subprocess with its output in a log file polls that file for the
line, under a deadline, instead of sleeping a fixed time (a loaded host
can take longer than any fixed sleep to bring the server up)."""

import time


def wait_for_dcp(proc, log_path, timeout: float = 20.0) -> None:
    """Block until ``proc``'s log at ``log_path`` holds the server's
    ``dcp listening on`` line; fail if the process exits first or the
    line has not come within ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        text = log_path.read_text()
        if "dcp listening on" in text:
            return
        assert proc.poll() is None, f"dcp server exited:\n{text[-2000:]}"
        assert time.monotonic() < deadline, (
            f"dcp server not listening after {timeout} s:\n{text[-2000:]}")
        time.sleep(0.05)
