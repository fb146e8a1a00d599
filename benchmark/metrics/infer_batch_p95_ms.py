"""95th percentile over all batches of the window of the time from a
batch's submission to its detections on the host, in ms."""
import statistics


def read(rec):
    lat = [i["latency_s"] * 1e3 for i in rec["items"] if "latency_s" in i]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
