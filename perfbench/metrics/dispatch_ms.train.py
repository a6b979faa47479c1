"""Mean host seconds of one ``Trainer.run_epoch()`` call in the window
(the benchmark's own span around each call), in ms.  Once the launch
queue is full a call waits for the device, so it reads the device step."""


def read(run):
    if run["kind"] != "train" or not run["dispatch_s"]:
        return None
    return sum(run["dispatch_s"]) / len(run["dispatch_s"]) * 1e3
