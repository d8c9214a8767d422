"""kNN kernel launches a request, from the port's count of them
(``kernels/knn.py``, the counter ``knn``) over the requests of the window
before the profiled span."""


def read(readings):
    launches, requests = readings.get("knn_launches"), readings.get("requests")
    if launches is None or not requests:
        return None
    return launches / requests
