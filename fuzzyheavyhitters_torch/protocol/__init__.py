"""The frontier crawl and the in-process two-server driver."""
