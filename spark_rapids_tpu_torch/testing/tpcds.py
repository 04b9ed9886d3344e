"""TPC-DS tables for the port: a copy of the JAX package's generator
(``spark_rapids_tpu/testing/tpcds.py``: ``_BASE``, ``_money`` and
``generate_tables`` ``:82``), kept here because the port imports nothing of
the JAX package and ``chip_smoke.py`` needs the tables on a machine
without it.  It is host numpy; the same ``sf`` and ``seed`` give the same
arrays as the JAX package's generator, column by column (a test checks).

Row counts scale with ``sf`` from ``_BASE`` (store_sales 30,000 rows per
sf); date_dim and the other small dimensions do not scale.  Money columns
are doubles rounded to cents, as in the JAX package.

``Q3_COLUMNS``, ``Q1_COLUMNS``, ``Q7_COLUMNS``, ``Q15_COLUMNS``,
``Q12_COLUMNS``, ``Q20_COLUMNS``, ``Q13_COLUMNS``, ``Q19_COLUMNS`` and
``Q16_COLUMNS`` name the columns each query reads; ``q3_tables`` to
``q16_tables`` cut the generator's dict down to them (the port has no
column pruning), sharing its arrays.  ``q3``, ``q1``, ``q7``, ``q15``,
``q12`` (q20 is ``q12(..., prefix="cs")``), ``q13``, ``q19`` and ``q16``
are the queries of ``spark_rapids_tpu/testing/tpcds_queries.py`` as
DataFrame recipes (the port has no SQL front end), and ``q3_numpy`` to
``q16_numpy`` the same queries in numpy; later slices add more, each with
its ``_COLUMNS``, ``_tables`` and ``_numpy`` (q17, q10, q18, q6, q28,
q36, q51, q51w, q8 and q5)."""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np


_BASE = {
    "store_sales": 30_000,
    "store_returns": 3_000,
    "catalog_sales": 15_000,
    "catalog_returns": 1_500,
    "web_sales": 8_000,
    "web_returns": 800,
    "customer": 2_000,
    "customer_address": 1_000,
    "customer_demographics": 1_920,
    "household_demographics": 720,
    "item": 2_000,
    "store": 12,
    "promotion": 30,
    "reason": 35,
    "web_site": 6,
    "catalog_page": 120,
    "call_center": 6,
    "date_dim": 1_461,   # 4 years: 1998-2002
    "warehouse": 5,
    "inventory": 20_000,
}

_STATES = np.array(["TN", "GA", "AL", "SC", "NC", "KY", "VA", "FL", "MS",
                    "TX"])
_COUNTIES = np.array([
    "Rush County", "Toole County", "Jefferson County", "Dona Ana County",
    "La Porte County", "Ziebach County", "Fairfield County", "Walker County",
    "Daviess County", "Barrow County"])
_CATEGORIES = np.array(["Sports", "Books", "Home", "Electronics", "Jewelry",
                        "Men", "Women", "Music", "Children", "Shoes"])
_EDU = np.array(["Primary", "Secondary", "College", "2 yr Degree",
                 "4 yr Degree", "Advanced Degree", "Unknown"])
_DAYS = np.array(["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                  "Friday", "Saturday"])

# zip pool overlapping the literal IN-lists the queries carry (q8 names 120
# specific 5-digit zips and then requires >2 preferred customers per zip —
# uniform 5-digit zips make its result empty at every realistic SF); half
# the pool comes from q8's list, half is filler, all reused heavily so the
# HAVING count(*) > 2 clause can fire
_ZIP_POOL = np.array([
    "24128", "76232", "65084", "87816", "83926", "77556", "20548", "26231",
    "43848", "15126", "91137", "61265", "98294", "25782", "17920", "18426",
    "98235", "40081", "84093", "28577", "55565", "17183", "54601", "67897",
    "30411", "12345", "55901", "77001", "94105", "60601", "30301", "73301",
    "85001", "19101", "48201", "63101", "37201", "40201", "23220", "29201"])


def _money(rng, n, lo=0.5, hi=300.0):
    return np.round(rng.uniform(lo, hi, n), 2)


def generate_tables(sf: float = 0.01, seed: int = 20) -> Dict[str, dict]:
    """Returns {table_name: column dict} ready for create_dataframe."""
    rng = np.random.default_rng(seed)
    n = {t: max(4, int(b * sf)) if t not in
         ("date_dim", "store", "reason", "web_site", "promotion",
          "catalog_page", "customer_demographics",
          "household_demographics", "warehouse") else b
         for t, b in _BASE.items()}
    t: Dict[str, dict] = {}

    # ---- date_dim: 1998-01-01 .. 2001-12-31, sk = julian-ish index -------
    nd = n["date_dim"]
    base = np.datetime64("1998-01-01")
    dates = base + np.arange(nd)
    dsk = 2_450_815 + np.arange(nd, dtype=np.int64)
    years = dates.astype("datetime64[Y]").astype(int) + 1970
    months = dates.astype("datetime64[M]").astype(int) % 12 + 1
    dom = (dates - dates.astype("datetime64[M]")).astype(int) + 1
    doy = (dates - dates.astype("datetime64[Y]")).astype(int)
    t["date_dim"] = {
        "d_date_sk": dsk,
        "d_date_id": np.array([f"AAAAAAAA{i:08d}" for i in range(nd)],
                              dtype=object),
        "d_date": dates.astype("datetime64[D]"),
        "d_year": years.astype(np.int32),
        "d_moy": months.astype(np.int32),
        "d_dom": dom.astype(np.int32),
        "d_qoy": ((months - 1) // 3 + 1).astype(np.int32),
        "d_week_seq": (5270 + (np.arange(nd) + 3) // 7).astype(np.int32),
        "d_month_seq": ((years - 1900) * 12 + months - 1).astype(np.int32),
        "d_day_name": _DAYS[(np.arange(nd) + 4) % 7].astype(object),
        "d_quarter_name": np.array(
            [f"{y}Q{(m - 1) // 3 + 1}" for y, m in zip(years, months)],
            dtype=object),
    }

    # ---- small dimensions -------------------------------------------------
    ns = n["store"]
    t["store"] = {
        "s_store_sk": np.arange(1, ns + 1, dtype=np.int64),
        "s_store_id": np.array([f"AAAAAAAA{i:04d}BAAA" for i in range(ns)],
                               dtype=object),
        "s_store_name": np.array(["ought", "able", "pri", "ese", "anti",
                                  "cally", "ation", "eing", "n st", "bar",
                                  "ought2", "able2"][:ns], dtype=object),
        "s_state": rng.choice(_STATES[:4], ns).astype(object),
        # store zips from the same pool as customer addresses so q8's
        # substr(s_zip,1,2) = substr(ca_zip,1,2) prefix join has matches
        "s_zip": rng.choice(_ZIP_POOL, ns).astype(object),
        "s_gmt_offset": np.full(ns, -5.0),
        "s_market_id": (np.arange(ns) % 10 + 1).astype(np.int32),
        "s_county": rng.choice(_COUNTIES[:5], ns).astype(object),
        "s_city": rng.choice(np.array(["Midway", "Fairview", "Oak Grove",
                                       "Glendale", "Centerville"]),
                             ns).astype(object),
        "s_number_employees": rng.integers(200, 301, ns).astype(np.int32),
    }
    nwh = n["warehouse"]
    t["warehouse"] = {
        "w_warehouse_sk": np.arange(1, nwh + 1, dtype=np.int64),
        "w_warehouse_name": np.array(
            [f"Warehouse number {i}" for i in range(1, nwh + 1)],
            dtype=object),
        "w_warehouse_sq_ft": rng.integers(50_000, 1_000_001, nwh).astype(
            np.int32),
        "w_city": rng.choice(np.array(["Midway", "Fairview", "Oak Grove"]),
                             nwh).astype(object),
        "w_county": rng.choice(_COUNTIES[:5], nwh).astype(object),
        "w_state": rng.choice(_STATES[:4], nwh).astype(object),
        "w_country": np.full(nwh, "United States", dtype=object),
    }
    nw = n["web_site"]
    t["web_site"] = {
        "web_site_sk": np.arange(1, nw + 1, dtype=np.int64),
        "web_site_id": np.array([f"site_{i}" for i in range(nw)],
                                dtype=object),
    }
    ncp = n["catalog_page"]
    t["catalog_page"] = {
        "cp_catalog_page_sk": np.arange(1, ncp + 1, dtype=np.int64),
        "cp_catalog_page_id": np.array([f"cpage_{i}" for i in range(ncp)],
                                       dtype=object),
    }
    ncc = n["call_center"]
    t["call_center"] = {
        "cc_call_center_sk": np.arange(1, ncc + 1, dtype=np.int64),
        "cc_call_center_id": np.array([f"cc_{i}" for i in range(ncc)],
                                      dtype=object),
        "cc_county": rng.choice(_COUNTIES[:5], ncc).astype(object),
        "cc_name": np.array([f"center {i}" for i in range(ncc)],
                            dtype=object),
        "cc_manager": np.array([f"Mgr{i}" for i in range(ncc)],
                               dtype=object),
    }
    nr = n["reason"]
    t["reason"] = {
        "r_reason_sk": np.arange(1, nr + 1, dtype=np.int64),
        "r_reason_desc": np.array([f"reason {i}" for i in range(nr)],
                                  dtype=object),
    }
    npm = n["promotion"]
    t["promotion"] = {
        "p_promo_sk": np.arange(1, npm + 1, dtype=np.int64),
        "p_channel_email": rng.choice(np.array(["N", "Y"]), npm,
                                      p=[0.9, 0.1]).astype(object),
        "p_channel_event": rng.choice(np.array(["N", "Y"]), npm,
                                      p=[0.9, 0.1]).astype(object),
        "p_channel_dmail": rng.choice(np.array(["N", "Y"]),
                                      npm).astype(object),
        "p_channel_tv": rng.choice(np.array(["N", "Y"]), npm).astype(object),
    }

    # ---- demographics -----------------------------------------------------
    ncd = n["customer_demographics"]
    genders = np.array(["M", "F"])
    marital = np.array(["M", "S", "D", "W", "U"])
    t["customer_demographics"] = {
        "cd_demo_sk": np.arange(1, ncd + 1, dtype=np.int64),
        "cd_gender": genders[np.arange(ncd) % 2].astype(object),
        "cd_marital_status": marital[(np.arange(ncd) // 2) % 5].astype(object),
        "cd_education_status": _EDU[(np.arange(ncd) // 10) % 7].astype(object),
        "cd_purchase_estimate": (500 * (1 + np.arange(ncd) % 20)).astype(
            np.int32),
        "cd_credit_rating": np.array(["Low Risk", "Good", "High Risk",
                                      "Unknown"])[
            (np.arange(ncd) // 70) % 4].astype(object),
        "cd_dep_count": (np.arange(ncd) % 7).astype(np.int32),
        "cd_dep_employed_count": (np.arange(ncd) % 7).astype(np.int32),
        "cd_dep_college_count": (np.arange(ncd) % 7).astype(np.int32),
    }
    nhd = n["household_demographics"]
    t["household_demographics"] = {
        "hd_demo_sk": np.arange(1, nhd + 1, dtype=np.int64),
        "hd_dep_count": (np.arange(nhd) % 10).astype(np.int32),
        "hd_buy_potential": np.array([">10000", "5001-10000", "1001-5000",
                                      "501-1000", "0-500", "Unknown"])[
            np.arange(nhd) % 6].astype(object),
        "hd_vehicle_count": (np.arange(nhd) % 5).astype(np.int32),
    }

    # ---- customer + address ----------------------------------------------
    nca = n["customer_address"]
    t["customer_address"] = {
        "ca_address_sk": np.arange(1, nca + 1, dtype=np.int64),
        "ca_state": rng.choice(_STATES, nca).astype(object),
        "ca_zip": rng.choice(_ZIP_POOL, nca).astype(object),
        "ca_county": rng.choice(_COUNTIES, nca).astype(object),
        "ca_country": np.full(nca, "United States", dtype=object),
        "ca_gmt_offset": rng.choice(np.array([-5.0, -6.0, -7.0]), nca),
        "ca_city": rng.choice(np.array(["Midway", "Fairview", "Oak Grove",
                                        "Glendale", "Centerville",
                                        "Pleasant Hill", "Springdale"]),
                              nca).astype(object),
    }
    nc = n["customer"]
    t["customer"] = {
        "c_customer_sk": np.arange(1, nc + 1, dtype=np.int64),
        "c_customer_id": np.array([f"AAAAAAAA{i:08d}" for i in range(nc)],
                                  dtype=object),
        "c_current_addr_sk": rng.integers(1, nca + 1, nc),
        "c_current_cdemo_sk": rng.integers(1, ncd + 1, nc),
        "c_current_hdemo_sk": rng.integers(1, nhd + 1, nc),
        "c_first_name": np.array([f"Name{i % 97}" for i in range(nc)],
                                 dtype=object),
        "c_last_name": np.array([f"Last{i % 89}" for i in range(nc)],
                                dtype=object),
        "c_preferred_cust_flag": rng.choice(np.array(["Y", "N"]),
                                            nc).astype(object),
        "c_birth_country": np.full(nc, "UNITED STATES", dtype=object),
        "c_birth_month": rng.integers(1, 13, nc).astype(np.int32),
        "c_birth_year": rng.integers(1930, 1995, nc).astype(np.int32),
        "c_birth_day": rng.integers(1, 29, nc).astype(np.int32),
        "c_email_address": np.array([f"c{i}@example.com"
                                     for i in range(nc)], dtype=object),
        "c_salutation": rng.choice(np.array(["Mr.", "Mrs.", "Ms.", "Dr.",
                                             "Sir"]), nc).astype(object),
        "c_login": np.array([f"login{i}" for i in range(nc)], dtype=object),
        "c_last_review_date_sk": rng.choice(dsk, nc),
    }

    # ---- item --------------------------------------------------------------
    ni = n["item"]
    t["item"] = {
        "i_item_sk": np.arange(1, ni + 1, dtype=np.int64),
        "i_item_id": np.array([f"AAAAAAAA{i:08d}" for i in range(ni)],
                              dtype=object),
        "i_item_desc": np.array([f"desc of item {i}" for i in range(ni)],
                                dtype=object),
        "i_current_price": _money(rng, ni, 0.5, 100.0),
        "i_category": rng.choice(_CATEGORIES, ni).astype(object),
        "i_class": np.array([f"class{i % 16}" for i in range(ni)],
                            dtype=object),
        "i_brand": np.array([f"brand{i % 50}" for i in range(ni)],
                            dtype=object),
        "i_brand_id": (1_000_000 + rng.integers(1, 1000, ni)).astype(
            np.int64),
        # deterministic cycle so the constants queries name (q3:
        # i_manufact_id = 128) are guaranteed present once ni >= 250 and
        # carry ~ni/250 items each — uniform random leaves them absent at
        # small scale and the differential oracle goes vacuous (0 == 0)
        "i_manufact_id": (np.arange(ni) % 250 + 1).astype(np.int64),
        "i_manufact": np.array([f"manufact{i % 250}" for i in range(ni)],
                               dtype=object),
        "i_category_id": rng.integers(1, 11, ni),
        "i_manager_id": rng.integers(1, 100, ni),
        # q24/q41 name specific colors; cycle a pool that includes them
        "i_color": np.array(["pale", "chiffon", "orchid", "powder", "peach",
                             "saddle", "sienna", "spring", "snow", "metallic",
                             "smoke", "almond", "khaki", "dim", "frosted",
                             "forest", "lime", "ghost", "navajo", "slate"])[
            np.arange(ni) % 20].astype(object),
        "i_units": np.array(["Ounce", "Oz", "Bunch", "Ton", "N/A", "Dozen",
                             "Box", "Pound", "Pallet", "Gross", "Cup",
                             "Dram", "Each", "Tbl", "Lb", "Bundle"])[
            np.arange(ni) % 16].astype(object),
        "i_size": np.array(["petite", "small", "medium", "large",
                            "extra large", "economy", "N/A"])[
            np.arange(ni) % 7].astype(object),
        "i_product_name": np.array([f"product{i}" for i in range(ni)],
                                   dtype=object),
        "i_wholesale_cost": _money(rng, ni, 0.5, 80.0),
    }
    nin = n["inventory"]
    # weekly snapshots: every 7th date, items cycling, warehouses cycling
    inv_dates = dsk[::7]
    t["inventory"] = {
        "inv_date_sk": inv_dates[np.arange(nin) % len(inv_dates)],
        "inv_item_sk": (np.arange(nin) % ni + 1).astype(np.int64),
        "inv_warehouse_sk": (np.arange(nin) % nwh + 1).astype(np.int64),
        "inv_quantity_on_hand": rng.integers(0, 1001, nin).astype(np.int32),
    }

    # ---- facts -------------------------------------------------------------
    def fact(prefix, count, cust_col, extra=None):
        m = {
            f"{prefix}_sold_date_sk": rng.choice(dsk, count),
            f"{prefix}_item_sk": rng.integers(1, ni + 1, count),
            f"{cust_col}": rng.integers(1, nc + 1, count),
            f"{prefix}_quantity": rng.integers(1, 101, count).astype(
                np.int32),
            f"{prefix}_list_price": _money(rng, count, 1, 300),
            f"{prefix}_sales_price": _money(rng, count, 1, 300),
            f"{prefix}_ext_sales_price": _money(rng, count, 1, 30_000),
            f"{prefix}_ext_discount_amt": _money(rng, count, 0, 1_000),
            f"{prefix}_ext_wholesale_cost": _money(rng, count, 1, 10_000),
            f"{prefix}_ext_list_price": _money(rng, count, 1, 30_000),
            f"{prefix}_coupon_amt": _money(rng, count, 0, 500),
            f"{prefix}_net_profit": np.round(
                rng.uniform(-5_000, 15_000, count), 2),
            f"{prefix}_net_paid": _money(rng, count, 1, 20_000),
            f"{prefix}_wholesale_cost": _money(rng, count, 1, 100),
            f"{prefix}_ext_ship_cost": _money(rng, count, 1, 1_000),
        }
        if extra:
            m.update(extra)
        return m

    nss = n["store_sales"]
    t["store_sales"] = fact("ss", nss, "ss_customer_sk", {
        "ss_cdemo_sk": rng.integers(1, ncd + 1, nss),
        "ss_hdemo_sk": rng.integers(1, nhd + 1, nss),
        "ss_addr_sk": rng.integers(1, nca + 1, nss),
        "ss_store_sk": rng.integers(1, ns + 1, nss),
        "ss_promo_sk": rng.integers(1, npm + 1, nss),
        "ss_ticket_number": (np.arange(nss) // 2 + 1).astype(np.int64),
    })
    nsr = n["store_returns"]
    # returns reference REAL sales lines (item/customer/ticket copied from
    # a sampled store_sales row) so the q17-style sale->return join is
    # non-vacuous; the return date lands after the sale
    sr_src = rng.integers(0, nss, nsr)
    _sale_dates = t["store_sales"]["ss_sold_date_sk"][sr_src]
    t["store_returns"] = {
        # return 1-90 days AFTER the referenced sale (clipped to the
        # calendar) so date-ordered return-window queries stay sound
        "sr_returned_date_sk": np.minimum(
            _sale_dates + rng.integers(1, 91, nsr), dsk[-1]),
        "sr_item_sk": t["store_sales"]["ss_item_sk"][sr_src],
        "sr_customer_sk": t["store_sales"]["ss_customer_sk"][sr_src],
        "sr_ticket_number": t["store_sales"]["ss_ticket_number"][sr_src],
        "sr_store_sk": rng.integers(1, ns + 1, nsr),
        "sr_return_amt": _money(rng, nsr, 1, 5_000),
        "sr_net_loss": _money(rng, nsr, 1, 2_000),
        "sr_return_quantity": rng.integers(1, 50, nsr).astype(np.int32),
    }
    ncs = n["catalog_sales"]
    t["catalog_sales"] = fact("cs", ncs, "cs_bill_customer_sk", {
        "cs_ship_customer_sk": rng.integers(1, nc + 1, ncs),
        "cs_bill_cdemo_sk": rng.integers(1, ncd + 1, ncs),
        "cs_call_center_sk": rng.integers(1, ncc + 1, ncs),
        "cs_catalog_page_sk": rng.integers(1, ncp + 1, ncs),
        # ~3 lines per order, several warehouses: q16's "ships from >1
        # warehouse" EXISTS needs same-order rows with differing sk
        "cs_order_number": (np.arange(ncs) // 3 + 1).astype(np.int64),
        "cs_warehouse_sk": rng.integers(1, nwh + 1, ncs),
        "cs_ship_date_sk": rng.choice(dsk, ncs),
        "cs_ship_addr_sk": rng.integers(1, nca + 1, ncs),
        "cs_promo_sk": rng.integers(1, npm + 1, ncs),
    })
    ncr = n["catalog_returns"]
    # returns reference REAL catalog sale lines (order + item copied from a
    # sampled row) so the q40-style cs->cr outer join is non-vacuous
    cr_src = rng.integers(0, ncs, ncr)
    t["catalog_returns"] = {
        "cr_returned_date_sk": rng.choice(dsk, ncr),
        "cr_catalog_page_sk": rng.integers(1, ncp + 1, ncr),
        "cr_order_number": t["catalog_sales"]["cs_order_number"][cr_src],
        "cr_item_sk": t["catalog_sales"]["cs_item_sk"][cr_src],
        "cr_return_amount": _money(rng, ncr, 1, 5_000),
        "cr_refunded_cash": _money(rng, ncr, 1, 3_000),
        "cr_net_loss": _money(rng, ncr, 1, 2_000),
        "cr_returning_customer_sk": rng.integers(1, nc + 1, ncr),
    }
    nws = n["web_sales"]
    t["web_sales"] = fact("ws", nws, "ws_bill_customer_sk", {
        "ws_web_site_sk": rng.integers(1, nw + 1, nws),
        "ws_web_page_sk": rng.integers(1, 61, nws),
    })
    nwr = n["web_returns"]
    t["web_returns"] = {
        "wr_returned_date_sk": rng.choice(dsk, nwr),
        "wr_web_page_sk": rng.integers(1, 61, nwr),
        "wr_return_amt": _money(rng, nwr, 1, 5_000),
        "wr_net_loss": _money(rng, nwr, 1, 2_000),
        "wr_returning_customer_sk": rng.integers(1, nc + 1, nwr),
        "wr_returning_addr_sk": rng.integers(1, nca + 1, nwr),
        "wr_item_sk": rng.integers(1, ni + 1, nwr),
        "wr_order_number": (np.arange(nwr) + 1).astype(np.int64),
    }
    return t


#: the columns of each table that TPC-DS q3 reads
Q3_COLUMNS = {
    "date_dim": ["d_date_sk", "d_year", "d_moy"],
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
    "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manufact_id"],
}


def partitioned_frames(session, tables: Dict[str, dict], names,
                       num_partitions: int = 2) -> list:
    """Each named table (a column dict or a host batch) as a DataFrame at
    ``num_partitions`` partitions, by the JAX package's
    ``register_tables`` rule (``spark_rapids_tpu/testing/tpcds.py:414``,
    ``:432``): a table under 1000 rows stays whole; the partitions are
    cut as ``create_dataframe`` cuts them."""
    out = []
    for name in names:
        cols = tables[name]
        rows = cols.row_count if hasattr(cols, "row_count") else \
            len(next(iter(cols.values())))
        out.append(session.create_dataframe(
            cols, num_partitions=num_partitions if rows >= 1000 else 1))
    return out


def q3_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q3 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q3_COLUMNS.items()}


def q3(date_dim, store_sales, item, manufact_id=128, month=11, limit=100):
    """TPC-DS q3 through the port's DataFrame API, over DataFrames of the
    ``Q3_COLUMNS`` of each table.  Returns ``(result, parts)``: ``parts``
    names the intermediate DataFrames (``dt``, ``ss``, ``it``, ``j1``,
    ``j2``, ``agg``, ``sorted``), so a caller can run each step alone.
    ``manufact_id=None`` drops the item filter and ``limit=None`` the
    limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo
    dt = date_dim.filter(EqualTo(col("d_moy"), lit(month)))
    ss = store_sales.select(Alias(col("ss_sold_date_sk"), "d_date_sk"),
                            col("ss_item_sk"), col("ss_ext_sales_price"))
    it = item if manufact_id is None else \
        item.filter(EqualTo(col("i_manufact_id"), lit(manufact_id)))
    it = it.select(Alias(col("i_item_sk"), "ss_item_sk"), col("i_brand_id"),
                   col("i_brand"))
    j1 = dt.join(ss, on="d_date_sk")
    j2 = j1.join(it, on="ss_item_sk")
    agg = (j2.group_by("d_year", "i_brand_id", "i_brand")
           .agg(F.sum("ss_ext_sales_price").alias("sum_agg"))
           .select(col("d_year"), Alias(col("i_brand_id"), "brand_id"),
                   Alias(col("i_brand"), "brand"), col("sum_agg")))
    ordered = agg.order_by("d_year", F.desc("sum_agg"), "brand_id")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"dt": dt, "ss": ss, "it": it, "j1": j1, "j2": j2,
                 "agg": agg, "sorted": ordered}


def q3_numpy(tables: Dict[str, dict], manufact_id=128, month=11,
             limit=100) -> list:
    """TPC-DS q3 in numpy over ``q3_tables`` output: the rows as dicts."""
    d, s, i = tables["date_dim"], tables["store_sales"], tables["item"]
    dmask = d["d_moy"] == month
    year_of = dict(zip(d["d_date_sk"][dmask].tolist(),
                       d["d_year"][dmask].tolist()))
    imask = np.ones(len(i["i_item_sk"]), bool) if manufact_id is None \
        else i["i_manufact_id"] == manufact_id
    item_of = dict(zip(i["i_item_sk"][imask].tolist(),
                       zip(i["i_brand_id"][imask].tolist(),
                           i["i_brand"][imask].tolist())))
    sel = np.isin(s["ss_sold_date_sk"], np.fromiter(year_of, np.int64)) & \
        np.isin(s["ss_item_sk"], np.fromiter(item_of, np.int64))
    sums: Dict[tuple, float] = {}
    for dk, ik, v in zip(s["ss_sold_date_sk"][sel].tolist(),
                         s["ss_item_sk"][sel].tolist(),
                         s["ss_ext_sales_price"][sel].tolist()):
        key = (year_of[dk],) + item_of[ik]
        sums[key] = sums.get(key, 0.0) + v
    rows = sorted(sums.items(), key=lambda kv: (kv[0][0], -kv[1], kv[0][1]))
    if limit is not None:
        rows = rows[:limit]
    return [{"d_year": k[0], "brand_id": k[1], "brand": k[2], "sum_agg": v}
            for k, v in rows]


#: the columns of each table that TPC-DS q1 reads
Q1_COLUMNS = {
    "date_dim": ["d_date_sk", "d_year"],
    "store_returns": ["sr_returned_date_sk", "sr_customer_sk",
                      "sr_store_sk", "sr_return_amt"],
    "store": ["s_store_sk", "s_state"],
    "customer": ["c_customer_sk", "c_customer_id"],
}

#: the columns of each table that TPC-DS q7 reads
Q7_COLUMNS = {
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk",
                    "ss_promo_sk", "ss_quantity", "ss_list_price",
                    "ss_coupon_amt", "ss_sales_price"],
    "customer_demographics": ["cd_demo_sk", "cd_gender",
                              "cd_marital_status", "cd_education_status"],
    "date_dim": ["d_date_sk", "d_year"],
    "item": ["i_item_sk", "i_item_id"],
    "promotion": ["p_promo_sk", "p_channel_email", "p_channel_event"],
}


def q1_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q1 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q1_COLUMNS.items()}


def q7_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q7 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q7_COLUMNS.items()}


def cte(df):
    """``df`` as a common table expression: a plan that several branches
    of one query read runs once per action (``TorchCteCacheExec``), as
    the JAX package's analyzer wraps a ``WITH`` name used twice."""
    from spark_rapids_tpu_torch.plan import base as L
    from spark_rapids_tpu_torch.session import DataFrame
    return DataFrame(L.CteCache([df._plan]), df._session)


def q1(date_dim, store_returns, store, customer, year=2000, state="TN",
       limit=100):
    """TPC-DS q1 through the port's DataFrame API, over DataFrames of the
    ``Q1_COLUMNS`` of each table, in the JAX plan's join order: the
    ``customer_total_return`` CTE (store_returns joined with the year's
    dates, summed by customer and store) joined with the state's stores,
    then with customer, then, left outer, with the decorrelated scalar
    subquery (the CTE's average by store times 1.2); the rows above it
    keep their customer ids, ordered.  Returns ``(result, parts)``, the
    intermediate DataFrames named in ``parts`` (``ctr``, ``avg``,
    ``joined``, ``sorted``).  ``limit=None`` drops the limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.arithmetic import Multiply
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (EqualTo,
                                                               GreaterThan)
    dt = date_dim.filter(EqualTo(col("d_year"), lit(year))) \
        .select(Alias(col("d_date_sk"), "sr_returned_date_sk"))
    sr = store_returns.select(col("sr_returned_date_sk"),
                              Alias(col("sr_customer_sk"), "ctr_customer_sk"),
                              Alias(col("sr_store_sk"), "ctr_store_sk"),
                              col("sr_return_amt"))
    ctr = cte(sr.join(dt, on="sr_returned_date_sk")
              .group_by("ctr_customer_sk", "ctr_store_sk")
              .agg(F.sum("sr_return_amt").alias("ctr_total_return")))
    st = store.filter(EqualTo(col("s_state"), lit(state))) \
        .select(Alias(col("s_store_sk"), "ctr_store_sk"))
    cu = customer.select(Alias(col("c_customer_sk"), "ctr_customer_sk"),
                         col("c_customer_id"))
    avg = (ctr.group_by("ctr_store_sk")
           .agg(F.avg("ctr_total_return").alias("avg_return"))
           .select(col("ctr_store_sk"),
                   Alias(Multiply(col("avg_return"), lit(1.2)), "_sval")))
    joined = (ctr.join(st, on="ctr_store_sk")
              .join(cu, on="ctr_customer_sk")
              .join(avg, on="ctr_store_sk", how="left_outer"))
    ordered = (joined.filter(GreaterThan(col("ctr_total_return"),
                                         col("_sval")))
               .select(col("c_customer_id"))
               .order_by("c_customer_id"))
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"ctr": ctr, "avg": avg, "joined": joined,
                 "sorted": ordered}


def q1_numpy(tables: Dict[str, dict], year=2000, state="TN",
             limit=100) -> list:
    """TPC-DS q1 in numpy over ``q1_tables`` output: the rows as dicts."""
    d, sr = tables["date_dim"], tables["store_returns"]
    s, c = tables["store"], tables["customer"]
    sel = np.isin(sr["sr_returned_date_sk"],
                  d["d_date_sk"][d["d_year"] == year])
    totals: Dict[tuple, float] = {}
    for ck, sk, v in zip(sr["sr_customer_sk"][sel].tolist(),
                         sr["sr_store_sk"][sel].tolist(),
                         sr["sr_return_amt"][sel].tolist()):
        totals[(ck, sk)] = totals.get((ck, sk), 0.0) + v
    by_store: Dict[int, list] = {}
    for (_ck, sk), v in totals.items():
        by_store.setdefault(sk, []).append(v)
    limit_of = {sk: sum(vs) / len(vs) * 1.2 for sk, vs in by_store.items()}
    states = set(s["s_store_sk"][s["s_state"] == state].tolist())
    cid = dict(zip(c["c_customer_sk"].tolist(), c["c_customer_id"]))
    ids = sorted(cid[ck] for (ck, sk), v in totals.items()
                 if sk in states and ck in cid and v > limit_of[sk])
    if limit is not None:
        ids = ids[:limit]
    return [{"c_customer_id": x} for x in ids]


def q7(store_sales, customer_demographics, date_dim, item, promotion,
       year=2000, gender="M", marital="S", education="College", limit=100):
    """TPC-DS q7 through the port's DataFrame API, over DataFrames of the
    ``Q7_COLUMNS`` of each table, in the JAX plan's join order:
    store_sales joined with the filtered customer_demographics, date_dim
    and item, then the promotions reached by email or event; four
    averages by item id, ordered.  Returns ``(result, parts)``
    (``joined``, ``agg``, ``sorted``).  ``limit=None`` drops the
    limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo, Or
    cd = (customer_demographics
          .filter(EqualTo(col("cd_gender"), lit(gender)))
          .filter(EqualTo(col("cd_marital_status"), lit(marital)))
          .filter(EqualTo(col("cd_education_status"), lit(education)))
          .select(Alias(col("cd_demo_sk"), "ss_cdemo_sk")))
    dt = date_dim.filter(EqualTo(col("d_year"), lit(year))) \
        .select(Alias(col("d_date_sk"), "ss_sold_date_sk"))
    it = item.select(Alias(col("i_item_sk"), "ss_item_sk"), col("i_item_id"))
    pr = promotion.filter(Or(EqualTo(col("p_channel_email"), lit("N")),
                             EqualTo(col("p_channel_event"), lit("N")))) \
        .select(Alias(col("p_promo_sk"), "ss_promo_sk"))
    joined = (store_sales.join(cd, on="ss_cdemo_sk")
              .join(dt, on="ss_sold_date_sk")
              .join(it, on="ss_item_sk")
              .join(pr, on="ss_promo_sk"))
    agg = joined.group_by("i_item_id").agg(
        F.avg("ss_quantity").alias("agg1"),
        F.avg("ss_list_price").alias("agg2"),
        F.avg("ss_coupon_amt").alias("agg3"),
        F.avg("ss_sales_price").alias("agg4"))
    ordered = agg.order_by("i_item_id")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"joined": joined, "agg": agg, "sorted": ordered}


def q7_numpy(tables: Dict[str, dict], year=2000, gender="M", marital="S",
             education="College", limit=100) -> list:
    """TPC-DS q7 in numpy over ``q7_tables`` output: the rows as dicts."""
    ss, cd = tables["store_sales"], tables["customer_demographics"]
    d, i, p = tables["date_dim"], tables["item"], tables["promotion"]
    cds = cd["cd_demo_sk"][(cd["cd_gender"] == gender) &
                           (cd["cd_marital_status"] == marital) &
                           (cd["cd_education_status"] == education)]
    promos = p["p_promo_sk"][(p["p_channel_email"] == "N") |
                             (p["p_channel_event"] == "N")]
    sel = np.isin(ss["ss_cdemo_sk"], cds) & \
        np.isin(ss["ss_sold_date_sk"], d["d_date_sk"][d["d_year"] == year]) \
        & np.isin(ss["ss_promo_sk"], promos) & \
        np.isin(ss["ss_item_sk"], i["i_item_sk"])
    item_id = dict(zip(i["i_item_sk"].tolist(), i["i_item_id"]))
    cols = ("ss_quantity", "ss_list_price", "ss_coupon_amt",
            "ss_sales_price")
    acc: Dict[str, list] = {}
    for row in zip(ss["ss_item_sk"][sel].tolist(),
                   *(ss[c][sel].tolist() for c in cols)):
        a = acc.setdefault(item_id[row[0]], [0.0, 0.0, 0.0, 0.0, 0])
        for j in range(4):
            a[j] += row[1 + j]
        a[4] += 1
    rows = sorted(acc.items())
    if limit is not None:
        rows = rows[:limit]
    return [{"i_item_id": k, "agg1": a[0] / a[4], "agg2": a[1] / a[4],
             "agg3": a[2] / a[4], "agg4": a[3] / a[4]} for k, a in rows]


#: the columns of each table that TPC-DS q15 reads
Q15_COLUMNS = {
    "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                      "cs_sales_price"],
    "customer": ["c_customer_sk", "c_current_addr_sk"],
    "customer_address": ["ca_address_sk", "ca_state", "ca_zip"],
    "date_dim": ["d_date_sk", "d_year", "d_qoy"],
}

_ITEM_Q12 = ["i_item_sk", "i_item_id", "i_item_desc", "i_category",
             "i_class", "i_current_price"]
#: the columns of each table that TPC-DS q12 (web_sales) and q20
#: (catalog_sales) read
Q12_COLUMNS = {
    "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_ext_sales_price"],
    "item": _ITEM_Q12,
    "date_dim": ["d_date_sk", "d_date"],
}
Q20_COLUMNS = {
    "catalog_sales": ["cs_sold_date_sk", "cs_item_sk", "cs_ext_sales_price"],
    "item": _ITEM_Q12,
    "date_dim": ["d_date_sk", "d_date"],
}

Q15_ZIPS = ("85669", "86197", "88274", "83405", "86475", "85392", "85460",
            "80348", "81792")
Q15_STATES = ("CA", "WA", "GA")
Q12_CATEGORIES = ("Sports", "Books", "Home")
Q12_DATES = (datetime.date(1999, 2, 22), datetime.date(1999, 3, 24))


def q15_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q15 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q15_COLUMNS.items()}


def q12_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q12 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q12_COLUMNS.items()}


def q20_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q20 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q20_COLUMNS.items()}


def q15(catalog_sales, customer, customer_address, date_dim, year=2001,
        qoy=2, limit=100):
    """TPC-DS q15 through the port's DataFrame API, over DataFrames of the
    ``Q15_COLUMNS`` of each table, in the JAX plan's join order:
    catalog_sales joined with customer, then customer_address, then the
    quarter's dates; then the filter ``substr(ca_zip, 1, 5) IN (...) OR
    ca_state IN (...) OR cs_sales_price > 500``, the sum by ``ca_zip``,
    ordered.  Returns ``(result, parts)`` (``joined``, ``agg``,
    ``sorted``).  ``limit=None`` drops the limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, EqualTo, GreaterThan, In, Or)
    cs = catalog_sales
    cu = customer.select(Alias(col("c_customer_sk"), "cs_bill_customer_sk"),
                         col("c_current_addr_sk"))
    ca = customer_address.select(Alias(col("ca_address_sk"),
                                       "c_current_addr_sk"),
                                 col("ca_state"), col("ca_zip"))
    dt = date_dim.filter(And(EqualTo(col("d_qoy"), lit(qoy)),
                             EqualTo(col("d_year"), lit(year)))) \
        .select(Alias(col("d_date_sk"), "cs_sold_date_sk"))
    joined = (cs.join(cu, on="cs_bill_customer_sk")
              .join(ca, on="c_current_addr_sk")
              .join(dt, on="cs_sold_date_sk"))
    cond = Or(Or(In(F.substring("ca_zip", 1, 5), Q15_ZIPS),
                 In(col("ca_state"), Q15_STATES)),
              GreaterThan(col("cs_sales_price"), lit(500.0)))
    agg = joined.filter(cond).group_by("ca_zip").agg(
        F.sum("cs_sales_price").alias("total_price"))
    ordered = agg.order_by("ca_zip")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"joined": joined, "agg": agg, "sorted": ordered}


def q15_numpy(tables: Dict[str, dict], year=2001, qoy=2,
              limit=100) -> list:
    """TPC-DS q15 in numpy over ``q15_tables`` output: the rows as dicts."""
    cs, c = tables["catalog_sales"], tables["customer"]
    ca, d = tables["customer_address"], tables["date_dim"]
    dates = d["d_date_sk"][(d["d_qoy"] == qoy) & (d["d_year"] == year)]
    addr_of = dict(zip(c["c_customer_sk"].tolist(),
                       c["c_current_addr_sk"].tolist()))
    place = dict(zip(ca["ca_address_sk"].tolist(),
                     zip(ca["ca_zip"].tolist(), ca["ca_state"].tolist())))
    sel = np.isin(cs["cs_sold_date_sk"], dates)
    sums: Dict[str, float] = {}
    for ck, price in zip(cs["cs_bill_customer_sk"][sel].tolist(),
                         cs["cs_sales_price"][sel].tolist()):
        ak = addr_of.get(ck)
        if ak not in place:
            continue
        z, st = place[ak]
        if z[:5] in Q15_ZIPS or st in Q15_STATES or price > 500:
            sums[z] = sums.get(z, 0.0) + price
    rows = sorted(sums.items())
    if limit is not None:
        rows = rows[:limit]
    return [{"ca_zip": z, "total_price": v} for z, v in rows]


def q12(sales, item, date_dim, prefix="ws", limit=100):
    """TPC-DS q12 (``prefix="ws"``, web_sales) or q20 (``prefix="cs"``,
    catalog_sales) through the port's DataFrame API, over DataFrames of
    the ``Q12_COLUMNS`` or ``Q20_COLUMNS``, in the JAX plan's order: the
    sales joined with the items of three categories, then with the dates
    of 1999-02-22 to 1999-03-24; the revenue summed by five item columns;
    each item's share of its class's revenue, ``itemrevenue * 100.0 /
    sum(itemrevenue) OVER (PARTITION BY i_class)``; ordered by five keys.
    Returns ``(result, parts)`` (``joined``, ``agg``, ``windowed``,
    ``sorted``).  ``limit=None`` drops the limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.arithmetic import (Divide,
                                                               Multiply)
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, GreaterThanOrEqual, In, LessThanOrEqual)
    from spark_rapids_tpu_torch.functions import Window
    item_key, date_key = f"{prefix}_item_sk", f"{prefix}_sold_date_sk"
    it = (item.filter(In(col("i_category"), Q12_CATEGORIES))
          .select(Alias(col("i_item_sk"), item_key), *map(col, KEYS_Q12)))
    lo, hi = Q12_DATES
    dt = date_dim.filter(And(GreaterThanOrEqual(col("d_date"), lit(lo)),
                             LessThanOrEqual(col("d_date"), lit(hi)))) \
        .select(Alias(col("d_date_sk"), date_key))
    joined = sales.join(it, on=item_key).join(dt, on=date_key)
    agg = joined.group_by(*KEYS_Q12).agg(
        F.sum(f"{prefix}_ext_sales_price").alias("itemrevenue"))
    share = Divide(Multiply(col("itemrevenue"), lit(100.0)),
                   F.sum("itemrevenue").over(Window.partition_by("i_class")))
    windowed = agg.select(*map(col, KEYS_Q12), col("itemrevenue"),
                          Alias(share, "revenueratio"))
    ordered = windowed.order_by("i_category", "i_class", "i_item_id",
                                "i_item_desc", "revenueratio")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"joined": joined, "agg": agg, "windowed": windowed,
                 "sorted": ordered}


#: q12's and q20's grouping keys, in the SELECT's order
KEYS_Q12 = ["i_item_id", "i_item_desc", "i_category", "i_class",
            "i_current_price"]


def q12_numpy(tables: Dict[str, dict], prefix="ws", limit=100) -> list:
    """TPC-DS q12 (or q20 with ``prefix="cs"``) in numpy over
    ``q12_tables`` (``q20_tables``) output: the rows as dicts."""
    sales = tables["web_sales" if prefix == "ws" else "catalog_sales"]
    i, d = tables["item"], tables["date_dim"]
    lo, hi = (np.datetime64(x, "D") for x in Q12_DATES)
    dates = d["d_date_sk"][(d["d_date"] >= lo) & (d["d_date"] <= hi)]
    imask = np.isin(i["i_category"], Q12_CATEGORIES)
    item_of = dict(zip(i["i_item_sk"][imask].tolist(),
                       zip(*(i[k][imask].tolist() for k in KEYS_Q12))))
    sel = np.isin(sales[f"{prefix}_sold_date_sk"], dates) & \
        np.isin(sales[f"{prefix}_item_sk"], np.fromiter(item_of, np.int64))
    revenue: Dict[tuple, float] = {}
    for ik, v in zip(sales[f"{prefix}_item_sk"][sel].tolist(),
                     sales[f"{prefix}_ext_sales_price"][sel].tolist()):
        key = item_of[ik]
        revenue[key] = revenue.get(key, 0.0) + v
    by_class: Dict[str, float] = {}
    for key, v in revenue.items():
        by_class[key[3]] = by_class.get(key[3], 0.0) + v
    rows = [dict(zip(KEYS_Q12, key), itemrevenue=v,
                 revenueratio=v * 100.0 / by_class[key[3]])
            for key, v in revenue.items()]
    rows.sort(key=lambda r: (r["i_category"], r["i_class"], r["i_item_id"],
                             r["i_item_desc"], r["revenueratio"]))
    return rows if limit is None else rows[:limit]


def q20_numpy(tables: Dict[str, dict], limit=100) -> list:
    """TPC-DS q20 in numpy over ``q20_tables`` output."""
    return q12_numpy(tables, "cs", limit)


def _lookup(keys: np.ndarray, probe: np.ndarray):
    """``(found, position)``: whether each probe value is among ``keys``
    (unique) and, where it is, its index in ``keys``."""
    order = np.argsort(keys, kind="stable")
    at = np.searchsorted(keys[order], probe)
    at = np.minimum(at, max(len(keys) - 1, 0))
    found = keys[order][at] == probe if len(keys) else \
        np.zeros(len(probe), bool)
    return found, order[at]


#: the columns of each table that TPC-DS q13 reads
Q13_COLUMNS = {
    "store_sales": ["ss_sold_date_sk", "ss_store_sk", "ss_cdemo_sk",
                    "ss_hdemo_sk", "ss_addr_sk", "ss_quantity",
                    "ss_sales_price", "ss_ext_sales_price",
                    "ss_ext_wholesale_cost", "ss_net_profit"],
    "store": ["s_store_sk"],
    "customer_demographics": ["cd_demo_sk", "cd_marital_status",
                              "cd_education_status"],
    "household_demographics": ["hd_demo_sk", "hd_dep_count"],
    "customer_address": ["ca_address_sk", "ca_state", "ca_country"],
    "date_dim": ["d_date_sk", "d_year"],
}
#: q13's three demographic branches: (marital status, education,
#: household dep_count), with ``Q13_PRICES``' ss_sales_price band each
Q13_DEMOGRAPHICS = (("M", "Advanced Degree", 3), ("S", "College", 1),
                    ("W", "2 yr Degree", 1))
Q13_PRICES = ((100.0, 150.0), (50.0, 100.0), (150.0, 200.0))
#: q13's three address branches: states, with ``Q13_PROFITS``'
#: ss_net_profit band each
Q13_STATES = (("TX", "OH", "TN"), ("OR", "NM", "KY"), ("VA", "GA", "MS"))
Q13_PROFITS = ((100.0, 200.0), (150.0, 300.0), (50.0, 250.0))


def q13_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q13 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q13_COLUMNS.items()}


def q13(store_sales, store, customer_demographics, household_demographics,
        customer_address, date_dim, year=2001, prices=Q13_PRICES,
        profits=Q13_PROFITS):
    """TPC-DS q13 through the port's DataFrame API, over DataFrames of the
    ``Q13_COLUMNS`` of each table, in the JAX plan's join order:
    store_sales joined with store, customer_demographics,
    household_demographics, the United States' customer_address and the
    year's date_dim; then one global aggregate (three averages and a sum)
    whose filter, an AND of two ORs of three AND groups, is fused into
    kernel 1, as the JAX package's ``TpuFusedAgg[F]`` does.  ``prices``
    and ``profits`` are the three branches' ss_sales_price and
    ss_net_profit bands (``between``: both ends included).  Returns
    ``(result, parts)`` (``joined``)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, EqualTo, GreaterThanOrEqual, In, LessThanOrEqual, Or)

    def between(name, band):
        return And(GreaterThanOrEqual(col(name), lit(float(band[0]))),
                   LessThanOrEqual(col(name), lit(float(band[1]))))

    def any_of(conds):
        out = conds[0]
        for c in conds[1:]:
            out = Or(out, c)
        return out

    st = store.select(Alias(col("s_store_sk"), "ss_store_sk"))
    cd = customer_demographics.select(
        Alias(col("cd_demo_sk"), "ss_cdemo_sk"), col("cd_marital_status"),
        col("cd_education_status"))
    hd = household_demographics.select(
        Alias(col("hd_demo_sk"), "ss_hdemo_sk"), col("hd_dep_count"))
    ca = customer_address \
        .filter(EqualTo(col("ca_country"), lit("United States"))) \
        .select(Alias(col("ca_address_sk"), "ss_addr_sk"), col("ca_state"))
    dt = date_dim.filter(EqualTo(col("d_year"), lit(year))) \
        .select(Alias(col("d_date_sk"), "ss_sold_date_sk"))
    joined = (store_sales.join(st, on="ss_store_sk")
              .join(cd, on="ss_cdemo_sk")
              .join(hd, on="ss_hdemo_sk")
              .join(ca, on="ss_addr_sk")
              .join(dt, on="ss_sold_date_sk"))
    demographic = any_of([
        And(And(And(EqualTo(col("cd_marital_status"), lit(m)),
                    EqualTo(col("cd_education_status"), lit(e))),
                between("ss_sales_price", band)),
            EqualTo(col("hd_dep_count"), lit(dep)))
        for (m, e, dep), band in zip(Q13_DEMOGRAPHICS, prices)])
    address = any_of([And(In(col("ca_state"), states),
                          between("ss_net_profit", band))
                      for states, band in zip(Q13_STATES, profits)])
    out = joined.filter(And(demographic, address)).agg(
        F.avg("ss_quantity").alias("avg1"),
        F.avg("ss_ext_sales_price").alias("avg2"),
        F.avg("ss_ext_wholesale_cost").alias("avg3"),
        F.sum("ss_ext_wholesale_cost").alias("sum1"))
    return out, {"joined": joined}


def q13_numpy(tables: Dict[str, dict], year=2001, prices=Q13_PRICES,
              profits=Q13_PROFITS) -> list:
    """TPC-DS q13 in numpy over ``q13_tables`` output: the one row as a
    dict (its values None when no row passes the filter)."""
    ss, s = tables["store_sales"], tables["store"]
    cd, hd = tables["customer_demographics"], tables["household_demographics"]
    ca, d = tables["customer_address"], tables["date_dim"]
    # each branch's string tests run over the dimension rows, and reach
    # the fact rows through the join's row lookup
    sel = np.isin(ss["ss_store_sk"], s["s_store_sk"]) & \
        np.isin(ss["ss_sold_date_sk"], d["d_date_sk"][d["d_year"] == year])
    found, cd_at = _lookup(cd["cd_demo_sk"], ss["ss_cdemo_sk"])
    sel &= found
    found, hd_at = _lookup(hd["hd_demo_sk"], ss["ss_hdemo_sk"])
    dep = hd["hd_dep_count"][hd_at]
    sel &= found
    us = ca["ca_country"] == "United States"
    found, ca_at = _lookup(ca["ca_address_sk"][us], ss["ss_addr_sk"])
    state = ca["ca_state"][us]
    sel &= found
    price, profit = ss["ss_sales_price"], ss["ss_net_profit"]
    demographic = np.zeros(len(price), bool)
    for (m, e, dp), (lo, hi) in zip(Q13_DEMOGRAPHICS, prices):
        cd_ok = (cd["cd_marital_status"] == m) & \
            (cd["cd_education_status"] == e)
        demographic |= cd_ok[cd_at] & (dep == dp) & (price >= lo) & \
            (price <= hi)
    address = np.zeros(len(price), bool)
    for states, (lo, hi) in zip(Q13_STATES, profits):
        address |= np.isin(state, states)[ca_at] & (profit >= lo) & \
            (profit <= hi)
    sel &= demographic & address
    n = int(sel.sum())

    def avg(c):
        return float(ss[c][sel].astype(np.float64).sum() / n) if n else None
    return [{"avg1": avg("ss_quantity"), "avg2": avg("ss_ext_sales_price"),
             "avg3": avg("ss_ext_wholesale_cost"),
             "sum1": float(ss["ss_ext_wholesale_cost"][sel].sum())
             if n else None}]


#: the columns of each table that TPC-DS q19 reads
Q19_COLUMNS = {
    "date_dim": ["d_date_sk", "d_year", "d_moy"],
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                    "ss_store_sk", "ss_ext_sales_price"],
    "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manufact_id",
             "i_manufact", "i_manager_id"],
    "customer": ["c_customer_sk", "c_current_addr_sk"],
    "customer_address": ["ca_address_sk", "ca_zip"],
    "store": ["s_store_sk", "s_zip"],
}


def q19_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q19 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q19_COLUMNS.items()}


def q19(date_dim, store_sales, item, customer, customer_address, store,
        manager_id=8, month=11, year=1998, limit=100):
    """TPC-DS q19 through the port's DataFrame API, over DataFrames of the
    ``Q19_COLUMNS`` of each table, in the JAX plan's join order: the
    month's dates joined with store_sales, then the manager's items,
    customer, customer_address and store, one key each; then the filter
    ``substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)``, the sum by brand id,
    brand, manufacturer id and manufacturer, ordered by the sum
    (descending) and the four keys.  Returns ``(result, parts)``
    (``joined``, ``agg``, ``sorted``).  ``limit=None`` drops the limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (And, EqualTo,
                                                               NotEqual)
    dt = date_dim.filter(And(EqualTo(col("d_moy"), lit(month)),
                             EqualTo(col("d_year"), lit(year)))) \
        .select(Alias(col("d_date_sk"), "ss_sold_date_sk"))
    it = item.filter(EqualTo(col("i_manager_id"), lit(manager_id))) \
        .select(Alias(col("i_item_sk"), "ss_item_sk"), col("i_brand_id"),
                col("i_brand"), col("i_manufact_id"), col("i_manufact"))
    cu = customer.select(Alias(col("c_customer_sk"), "ss_customer_sk"),
                         col("c_current_addr_sk"))
    ca = customer_address.select(Alias(col("ca_address_sk"),
                                       "c_current_addr_sk"), col("ca_zip"))
    st = store.select(Alias(col("s_store_sk"), "ss_store_sk"), col("s_zip"))
    joined = (dt.join(store_sales, on="ss_sold_date_sk")
              .join(it, on="ss_item_sk")
              .join(cu, on="ss_customer_sk")
              .join(ca, on="c_current_addr_sk")
              .join(st, on="ss_store_sk"))
    agg = (joined.filter(NotEqual(F.substring("ca_zip", 1, 5),
                                  F.substring("s_zip", 1, 5)))
           .group_by("i_brand_id", "i_brand", "i_manufact_id", "i_manufact")
           .agg(F.sum("ss_ext_sales_price").alias("ext_price"))
           .select(Alias(col("i_brand_id"), "brand_id"),
                   Alias(col("i_brand"), "brand"), col("i_manufact_id"),
                   col("i_manufact"), col("ext_price")))
    ordered = agg.order_by(F.desc("ext_price"), "brand", "brand_id",
                           "i_manufact_id", "i_manufact")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"joined": joined, "agg": agg, "sorted": ordered}


def q19_numpy(tables: Dict[str, dict], manager_id=8, month=11, year=1998,
              limit=100) -> list:
    """TPC-DS q19 in numpy over ``q19_tables`` output: the rows as dicts."""
    d, ss, i = tables["date_dim"], tables["store_sales"], tables["item"]
    c, ca, s = tables["customer"], tables["customer_address"], tables["store"]
    dates = d["d_date_sk"][(d["d_moy"] == month) & (d["d_year"] == year)]
    sel = np.isin(ss["ss_sold_date_sk"], dates)
    mine = i["i_manager_id"] == manager_id
    found, item_at = _lookup(i["i_item_sk"][mine], ss["ss_item_sk"][sel])
    rows = np.nonzero(sel)[0][found]
    item_at = np.nonzero(mine)[0][item_at[found]]
    found, cust_at = _lookup(c["c_customer_sk"], ss["ss_customer_sk"][rows])
    rows, item_at, cust_at = rows[found], item_at[found], cust_at[found]
    found, addr_at = _lookup(ca["ca_address_sk"],
                             c["c_current_addr_sk"][cust_at])
    rows, item_at, addr_at = rows[found], item_at[found], addr_at[found]
    found, store_at = _lookup(s["s_store_sk"], ss["ss_store_sk"][rows])
    rows, item_at, addr_at, store_at = (rows[found], item_at[found],
                                        addr_at[found], store_at[found])
    sums: Dict[tuple, float] = {}
    for r, ia, aa, sa in zip(rows.tolist(), item_at.tolist(),
                             addr_at.tolist(), store_at.tolist()):
        if ca["ca_zip"][aa][:5] == s["s_zip"][sa][:5]:
            continue
        key = (int(i["i_brand_id"][ia]), i["i_brand"][ia],
               int(i["i_manufact_id"][ia]), i["i_manufact"][ia])
        sums[key] = sums.get(key, 0.0) + float(ss["ss_ext_sales_price"][r])
    out = sorted(sums.items(),
                 key=lambda kv: (-kv[1], kv[0][1], kv[0][0], kv[0][2],
                                 kv[0][3]))
    if limit is not None:
        out = out[:limit]
    return [{"brand_id": k[0], "brand": k[1], "i_manufact_id": k[2],
             "i_manufact": k[3], "ext_price": v} for k, v in out]


#: the columns of each table that TPC-DS q16 reads
Q16_COLUMNS = {
    "catalog_sales": ["cs_ship_date_sk", "cs_ship_addr_sk",
                      "cs_call_center_sk", "cs_order_number",
                      "cs_warehouse_sk", "cs_ext_ship_cost", "cs_net_profit"],
    "date_dim": ["d_date_sk", "d_date"],
    "customer_address": ["ca_address_sk", "ca_state"],
    "call_center": ["cc_call_center_sk", "cc_county"],
    "catalog_returns": ["cr_order_number"],
}
Q16_DATES = (datetime.date(1999, 2, 1), datetime.date(1999, 4, 2))
Q16_COUNTIES = ("Rush County", "Toole County", "Jefferson County",
                "Dona Ana County", "La Porte County")


def q16_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q16 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q16_COLUMNS.items()}


def q16(catalog_sales, date_dim, customer_address, call_center,
        catalog_returns, state="GA"):
    """TPC-DS q16 through the port's DataFrame API, over DataFrames of the
    ``Q16_COLUMNS`` of each table, in the JAX plan's order: catalog_sales
    joined with the ship dates of 1999-02-01 to 1999-04-02, the state's
    addresses and the five counties' call centers; then a left semi join
    with the orders shipped from more than one warehouse (the ``IN``
    subquery: ``count(DISTINCT cs_warehouse_sk) > 1`` by order), a left
    anti join with the returned orders (``NOT IN``, planned as a plain
    anti join as the JAX analyzer plans it) and one global aggregate:
    ``count(DISTINCT cs_order_number)`` and two sums.  The query's
    ``order by`` and ``limit`` over its one row are left out.  Returns
    ``(result, parts)`` (``joined``, ``multi``, ``kept``)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, EqualTo, GreaterThan, GreaterThanOrEqual, In, LessThanOrEqual)
    lo, hi = Q16_DATES
    dt = date_dim.filter(And(GreaterThanOrEqual(col("d_date"), lit(lo)),
                             LessThanOrEqual(col("d_date"), lit(hi)))) \
        .select(Alias(col("d_date_sk"), "cs_ship_date_sk"))
    ca = customer_address.filter(EqualTo(col("ca_state"), lit(state))) \
        .select(Alias(col("ca_address_sk"), "cs_ship_addr_sk"))
    cc = call_center.filter(In(col("cc_county"), Q16_COUNTIES)) \
        .select(Alias(col("cc_call_center_sk"), "cs_call_center_sk"))
    joined = (catalog_sales.join(dt, on="cs_ship_date_sk")
              .join(ca, on="cs_ship_addr_sk")
              .join(cc, on="cs_call_center_sk"))
    multi = (catalog_sales.group_by("cs_order_number")
             .agg(F.count_distinct("cs_warehouse_sk").alias("warehouses"))
             .filter(GreaterThan(col("warehouses"), lit(1)))
             .select(col("cs_order_number")))
    returned = catalog_returns.select(Alias(col("cr_order_number"),
                                            "cs_order_number"))
    kept = joined.join(multi, on="cs_order_number", how="semi") \
        .join(returned, on="cs_order_number", how="anti")
    out = kept.agg(F.count_distinct("cs_order_number").alias("order_count"),
                   F.sum("cs_ext_ship_cost").alias("total_shipping_cost"),
                   F.sum("cs_net_profit").alias("total_net_profit"))
    return out, {"joined": joined, "multi": multi, "kept": kept}


def q16_numpy(tables: Dict[str, dict], state="GA") -> list:
    """TPC-DS q16 in numpy over ``q16_tables`` output: the one row as a
    dict."""
    cs, d = tables["catalog_sales"], tables["date_dim"]
    ca, cc = tables["customer_address"], tables["call_center"]
    lo, hi = (np.datetime64(x, "D") for x in Q16_DATES)
    dates = d["d_date_sk"][(d["d_date"] >= lo) & (d["d_date"] <= hi)]
    order = cs["cs_order_number"]
    sel = np.isin(cs["cs_ship_date_sk"], dates) & \
        np.isin(cs["cs_ship_addr_sk"],
                ca["ca_address_sk"][ca["ca_state"] == state]) & \
        np.isin(cs["cs_call_center_sk"], cc["cc_call_center_sk"][
            np.isin(cc["cc_county"], Q16_COUNTIES)])
    # orders shipped from more than one warehouse: distinct (order,
    # warehouse) pairs, counted by order
    wh = cs["cs_warehouse_sk"].astype(np.int64)
    span = int(wh.max()) + 1 if len(wh) else 1
    pairs = np.unique(order.astype(np.int64) * span + wh)
    orders, n = np.unique(pairs // span, return_counts=True)
    sel &= np.isin(order, orders[n > 1])
    sel &= ~np.isin(order, tables["catalog_returns"]["cr_order_number"])
    any_row = bool(sel.any())
    return [{"order_count": int(len(np.unique(order[sel]))),
             "total_shipping_cost": float(cs["cs_ext_ship_cost"][sel].sum())
             if any_row else None,
             "total_net_profit": float(cs["cs_net_profit"][sel].sum())
             if any_row else None}]


def _key_pairs(left, right):
    """``(left rows, right rows)`` of every match of the key tuples
    ``left`` and ``right`` (lists of equal-length arrays, one per key
    column): an inner join's pairs, in numpy."""
    nl = len(left[0])
    if len(left) == 1:
        lk, rk = left[0].astype(np.int64), right[0].astype(np.int64)
    else:
        both = np.concatenate([np.stack(left, 1), np.stack(right, 1)])
        _u, ids = np.unique(both.astype(np.int64), axis=0,
                            return_inverse=True)
        ids = ids.ravel()
        lk, rk = ids[:nl], ids[nl:]
    order = np.argsort(rk, kind="stable")
    lo = np.searchsorted(rk[order], lk, "left")
    cnt = np.searchsorted(rk[order], lk, "right") - lo
    li = np.repeat(np.arange(nl), cnt)
    within = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return li, order[np.repeat(lo, cnt) + within]


def _group_ids(*columns):
    """One id per distinct tuple of ``columns`` (arrays of one length),
    and the tuples' first rows."""
    codes = [np.unique(c, return_inverse=True)[1].ravel().astype(np.int64)
             for c in columns]
    _u, first, gid = np.unique(np.stack(codes, 1), axis=0,
                               return_index=True, return_inverse=True)
    return gid.ravel(), first


#: the columns of each table that TPC-DS q17 reads
Q17_COLUMNS = {
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                    "ss_customer_sk", "ss_ticket_number", "ss_quantity"],
    "store_returns": ["sr_returned_date_sk", "sr_item_sk", "sr_customer_sk",
                      "sr_ticket_number", "sr_return_quantity"],
    "catalog_sales": ["cs_sold_date_sk", "cs_item_sk", "cs_bill_customer_sk",
                      "cs_quantity"],
    "date_dim": ["d_date_sk", "d_quarter_name"],
    "store": ["s_store_sk", "s_state"],
    "item": ["i_item_sk", "i_item_id", "i_item_desc"],
}
Q17_QUARTERS = ("2001Q1", "2001Q2", "2001Q3")
#: q17's output: each quantity's prefix and column
Q17_QUANTITIES = (("store_sales", "ss_quantity"),
                  ("store_returns", "sr_return_quantity"),
                  ("catalog_sales", "cs_quantity"))


def q17_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q17 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q17_COLUMNS.items()}


def q17(store_sales, store_returns, catalog_sales, date_dim, store, item,
        same_item=True, limit=100):
    """TPC-DS q17 through the port's DataFrame API, over DataFrames of the
    ``Q17_COLUMNS`` of each table.  date_dim is read three times, each
    copy's date key renamed to the fact column it joins (a selection, no
    launch), and each fact table meets its dates before the fact joins,
    so the 30M-row probe meets a small build: store_sales of 2001Q1
    joined with store_returns of 2001Q1 to Q3 on customer, item and
    ticket (three key columns), then with catalog_sales of the same
    quarters on customer and item (two; ``same_item=False`` drops the
    item, the one conjunct whose removal lets rows through on this
    generator), store and item; then count, avg and stddev_samp of the
    three quantities by item id, description and state (K9's count, sum
    and m2, sharing each quantity's count), ordered by the keys.  Returns
    ``(result, parts)`` (``joined``, ``agg``, ``sorted``).  ``limit=None``
    drops the limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo, In

    def dates(quarters, name):
        return date_dim.filter(In(col("d_quarter_name"), list(quarters))) \
            .select(Alias(col("d_date_sk"), name))
    d1 = date_dim.filter(EqualTo(col("d_quarter_name"), lit("2001Q1"))) \
        .select(Alias(col("d_date_sk"), "ss_sold_date_sk"))
    ss = store_sales.join(d1, on="ss_sold_date_sk")
    sr = (store_returns
          .join(dates(Q17_QUARTERS, "sr_returned_date_sk"),
                on="sr_returned_date_sk")
          .select(Alias(col("sr_customer_sk"), "ss_customer_sk"),
                  Alias(col("sr_item_sk"), "ss_item_sk"),
                  Alias(col("sr_ticket_number"), "ss_ticket_number"),
                  col("sr_return_quantity")))
    cs_keys = [Alias(col("cs_bill_customer_sk"), "ss_customer_sk")]
    if same_item:
        cs_keys.append(Alias(col("cs_item_sk"), "ss_item_sk"))
    cs = (catalog_sales
          .join(dates(Q17_QUARTERS, "cs_sold_date_sk"), on="cs_sold_date_sk")
          .select(*cs_keys, col("cs_quantity")))
    st = store.select(Alias(col("s_store_sk"), "ss_store_sk"), col("s_state"))
    it = item.select(Alias(col("i_item_sk"), "ss_item_sk"), col("i_item_id"),
                     col("i_item_desc"))
    joined = (ss.join(sr, on=["ss_customer_sk", "ss_item_sk",
                              "ss_ticket_number"])
              .join(cs, on=["ss_customer_sk", "ss_item_sk"] if same_item
                    else "ss_customer_sk")
              .join(st, on="ss_store_sk")
              .join(it, on="ss_item_sk"))
    aggs = []
    for table, c in Q17_QUANTITIES:
        name = f"{table}_quantity"
        aggs += [F.count(c).alias(f"{name}count"),
                 F.avg(c).alias(f"{name}ave"),
                 F.stddev_samp(c).alias(f"{name}stdev")]
    agg = joined.group_by("i_item_id", "i_item_desc", "s_state").agg(*aggs)
    ordered = agg.order_by("i_item_id", "i_item_desc", "s_state")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"joined": joined, "agg": agg, "sorted": ordered}


def _moments(gid, x, n_groups):
    """count, mean and stddev_samp of ``x`` (as doubles) per group: the
    mean, then the squared deviations from it; None where n < 2."""
    x = x.astype(np.float64)
    n = np.bincount(gid, minlength=n_groups)
    mean = np.bincount(gid, weights=x, minlength=n_groups) / \
        np.maximum(n, 1)
    m2 = np.bincount(gid, weights=(x - mean[gid]) ** 2, minlength=n_groups)
    sd = [float(np.sqrt(m / (k - 1))) if k > 1 else None
          for m, k in zip(m2.tolist(), n.tolist())]
    return n.tolist(), mean.tolist(), sd


def q17_numpy(tables: Dict[str, dict], same_item=True, limit=100) -> list:
    """TPC-DS q17 in numpy over ``q17_tables`` output: the rows as dicts."""
    ss, sr = tables["store_sales"], tables["store_returns"]
    cs, d = tables["catalog_sales"], tables["date_dim"]
    s, i = tables["store"], tables["item"]
    q = d["d_quarter_name"]
    d1 = d["d_date_sk"][q == "2001Q1"]
    d23 = d["d_date_sk"][np.isin(q, Q17_QUARTERS)]
    s_rows = np.nonzero(np.isin(ss["ss_sold_date_sk"], d1))[0]
    r_rows = np.nonzero(np.isin(sr["sr_returned_date_sk"], d23))[0]
    c_rows = np.nonzero(np.isin(cs["cs_sold_date_sk"], d23))[0]
    a, b = _key_pairs(
        [ss[c][s_rows] for c in ("ss_customer_sk", "ss_item_sk",
                                 "ss_ticket_number")],
        [sr[c][r_rows] for c in ("sr_customer_sk", "sr_item_sk",
                                 "sr_ticket_number")])
    s_at, r_at = s_rows[a], r_rows[b]
    left = [sr["sr_customer_sk"][r_at]]
    right = [cs["cs_bill_customer_sk"][c_rows]]
    if same_item:
        left.append(sr["sr_item_sk"][r_at])
        right.append(cs["cs_item_sk"][c_rows])
    a, b = _key_pairs(left, right)
    s_at, r_at, c_at = s_at[a], r_at[a], c_rows[b]
    found, st_at = _lookup(s["s_store_sk"], ss["ss_store_sk"][s_at])
    s_at, r_at, c_at, st_at = s_at[found], r_at[found], c_at[found], \
        st_at[found]
    found, it_at = _lookup(i["i_item_sk"], ss["ss_item_sk"][s_at])
    s_at, r_at, c_at, st_at, it_at = (s_at[found], r_at[found], c_at[found],
                                      st_at[found], it_at[found])
    if not len(s_at):
        return []
    keys = (i["i_item_id"][it_at], i["i_item_desc"][it_at],
            s["s_state"][st_at])
    gid, first = _group_ids(*keys)
    g = len(first)
    cols = {}
    for (table, c), rows, src in zip(Q17_QUANTITIES, (s_at, r_at, c_at),
                                     (ss, sr, cs)):
        n, mean, sd = _moments(gid, src[c][rows], g)
        name = f"{table}_quantity"
        cols[f"{name}count"], cols[f"{name}ave"] = n, mean
        cols[f"{name}stdev"] = sd
    out = []
    for k in range(g):
        row = {"i_item_id": keys[0][first[k]],
               "i_item_desc": keys[1][first[k]],
               "s_state": keys[2][first[k]]}
        for table, _c in Q17_QUANTITIES:
            name = f"{table}_quantity"
            row[f"{name}count"] = cols[f"{name}count"][k]
            row[f"{name}ave"] = cols[f"{name}ave"][k]
            row[f"{name}stdev"] = cols[f"{name}stdev"][k]
        out.append(row)
    out.sort(key=lambda r: (r["i_item_id"], r["i_item_desc"], r["s_state"]))
    return out if limit is None else out[:limit]


#: the columns of each table that TPC-DS q10 reads
Q10_COLUMNS = {
    "customer": ["c_customer_sk", "c_current_addr_sk", "c_current_cdemo_sk"],
    "customer_address": ["ca_address_sk", "ca_county"],
    "customer_demographics": [
        "cd_demo_sk", "cd_gender", "cd_marital_status", "cd_education_status",
        "cd_purchase_estimate", "cd_credit_rating", "cd_dep_count",
        "cd_dep_employed_count", "cd_dep_college_count"],
    "store_sales": ["ss_sold_date_sk", "ss_customer_sk"],
    "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk"],
    "catalog_sales": ["cs_sold_date_sk", "cs_ship_customer_sk"],
    "date_dim": ["d_date_sk", "d_year", "d_moy"],
}
Q10_COUNTIES = ("Rush County", "Toole County", "Jefferson County",
                "Dona Ana County", "La Porte County")
#: q10's eight grouping keys, each followed in the output by a count(*)
Q10_KEYS = ("cd_gender", "cd_marital_status", "cd_education_status",
            "cd_purchase_estimate", "cd_credit_rating", "cd_dep_count",
            "cd_dep_employed_count", "cd_dep_college_count")
#: q10's output columns, in the query's order
Q10_OUTPUT = ("cd_gender", "cd_marital_status", "cd_education_status",
              "cnt1", "cd_purchase_estimate", "cnt2", "cd_credit_rating",
              "cnt3", "cd_dep_count", "cnt4", "cd_dep_employed_count",
              "cnt5", "cd_dep_college_count", "cnt6")


def q10_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q10 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q10_COLUMNS.items()}


def q10(customer, customer_address, customer_demographics, store_sales,
        web_sales, catalog_sales, date_dim, year=2000, months=(1, 4),
        limit=100):
    """TPC-DS q10 through the port's DataFrame API, over DataFrames of the
    ``Q10_COLUMNS`` of each table, in the JAX analyzer's plan shape
    (``sql/analyzer.py:1047 _exists_join``): customer joined with the
    five counties' addresses and its demographics; the top-level
    ``EXISTS`` over store_sales of the months a left semi join; each of
    the two ``OR``-ed ``EXISTS`` a left outer join with the distinct
    customers of web_sales or catalog_sales in the months, each beside a
    TRUE marker (K6), and the filter ``m1 OR m2`` (Kleene, in K5) keeps
    a customer either marks; then six ``count(*)`` by the eight
    demographic keys (one K9 slot), ordered by them, in the query's
    column order.  Returns ``(result, parts)`` (``joined``, ``agg``,
    ``sorted``).  ``limit=None`` drops the limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, EqualTo, GreaterThanOrEqual, In, LessThanOrEqual, Or)
    lo, hi = months

    def dates(name):
        return date_dim.filter(And(
            EqualTo(col("d_year"), lit(year)),
            And(GreaterThanOrEqual(col("d_moy"), lit(lo)),
                LessThanOrEqual(col("d_moy"), lit(hi))))) \
            .select(Alias(col("d_date_sk"), name))

    def buyers(sales, prefix, customer_col):
        return (sales.join(dates(f"{prefix}_sold_date_sk"),
                           on=f"{prefix}_sold_date_sk")
                .select(Alias(col(customer_col), "c_customer_sk")))

    def marker(sales, prefix, customer_col, name):
        return buyers(sales, prefix, customer_col).distinct() \
            .select(col("c_customer_sk"), Alias(lit(True), name))
    ca = customer_address.filter(In(col("ca_county"), list(Q10_COUNTIES))) \
        .select(Alias(col("ca_address_sk"), "c_current_addr_sk"))
    cd = customer_demographics.select(
        Alias(col("cd_demo_sk"), "c_current_cdemo_sk"),
        *[col(k) for k in Q10_KEYS])
    joined = (customer.join(ca, on="c_current_addr_sk")
              .join(cd, on="c_current_cdemo_sk")
              .join(buyers(store_sales, "ss", "ss_customer_sk"),
                    on="c_customer_sk", how="semi")
              .join(marker(web_sales, "ws", "ws_bill_customer_sk", "m1"),
                    on="c_customer_sk", how="left")
              .join(marker(catalog_sales, "cs", "cs_ship_customer_sk",
                           "m2"), on="c_customer_sk", how="left")
              .filter(Or(col("m1"), col("m2"))))
    agg = joined.group_by(*Q10_KEYS).agg(
        *[F.count("*").alias(f"cnt{j}") for j in range(1, 7)])
    ordered = agg.order_by(*Q10_KEYS)
    out = ordered if limit is None else ordered.limit(limit)
    out = out.select(*[col(c) for c in Q10_OUTPUT])
    return out, {"joined": joined, "agg": agg, "sorted": ordered}


def q10_numpy(tables: Dict[str, dict], year=2000, months=(1, 4),
              limit=100) -> list:
    """TPC-DS q10 in numpy over ``q10_tables`` output: the rows as
    dicts."""
    c, ca = tables["customer"], tables["customer_address"]
    cd, d = tables["customer_demographics"], tables["date_dim"]
    lo, hi = months
    dates = d["d_date_sk"][(d["d_year"] == year) & (d["d_moy"] >= lo) &
                           (d["d_moy"] <= hi)]

    def buyers(table, prefix, customer_col):
        t = tables[table]
        return t[customer_col][np.isin(t[f"{prefix}_sold_date_sk"], dates)]
    sk = c["c_customer_sk"]
    sel = np.isin(c["c_current_addr_sk"], ca["ca_address_sk"][
        np.isin(ca["ca_county"], Q10_COUNTIES)])
    sel &= np.isin(sk, buyers("store_sales", "ss", "ss_customer_sk"))
    sel &= np.isin(sk, buyers("web_sales", "ws", "ws_bill_customer_sk")) | \
        np.isin(sk, buyers("catalog_sales", "cs", "cs_ship_customer_sk"))
    found, cd_at = _lookup(cd["cd_demo_sk"], c["c_current_cdemo_sk"][sel])
    cd_at = cd_at[found]
    counts: Dict[tuple, int] = {}
    for r in cd_at.tolist():
        key = tuple(cd[k][r] for k in Q10_KEYS)
        counts[key] = counts.get(key, 0) + 1
    out = []
    for key in sorted(counts):
        row = dict(zip(Q10_KEYS, key))
        out.append({name: row.get(name, counts[key]) for name in Q10_OUTPUT})
    out = [{k: (int(v) if isinstance(v, np.integer) else v)
            for k, v in r.items()} for r in out]
    return out if limit is None else out[:limit]


#: the columns of each table that TPC-DS q18 reads
Q18_COLUMNS = {
    "catalog_sales": ["cs_sold_date_sk", "cs_item_sk", "cs_bill_cdemo_sk",
                      "cs_bill_customer_sk", "cs_quantity", "cs_list_price",
                      "cs_coupon_amt", "cs_sales_price", "cs_net_profit"],
    "customer_demographics": ["cd_demo_sk", "cd_gender",
                              "cd_education_status", "cd_dep_count"],
    "customer": ["c_customer_sk", "c_current_cdemo_sk", "c_current_addr_sk",
                 "c_birth_month", "c_birth_year"],
    "customer_address": ["ca_address_sk", "ca_country", "ca_state",
                         "ca_county"],
    "date_dim": ["d_date_sk", "d_year"],
    "item": ["i_item_sk", "i_item_id"],
}
Q18_MONTHS = (1, 6, 8, 9, 12, 2)
Q18_STATES = ("MS", "IN", "ND", "OK", "NM", "VA", "MS")
#: the rollup keys, and the order of the output
Q18_KEYS = ("i_item_id", "ca_country", "ca_state", "ca_county")
Q18_ORDER = ("ca_country", "ca_state", "ca_county", "i_item_id")
#: q18's averages: output name and column (each cast to double)
Q18_AVERAGES = (("agg1", "cs_quantity"), ("agg2", "cs_list_price"),
                ("agg3", "cs_coupon_amt"), ("agg4", "cs_sales_price"),
                ("agg5", "cs_net_profit"), ("agg6", "c_birth_year"),
                ("agg7", "cd_dep_count"))


def q18_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q18 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q18_COLUMNS.items()}


def q18(catalog_sales, customer_demographics, customer, customer_address,
        date_dim, item, year=1998, limit=100):
    """TPC-DS q18 through the port's DataFrame API, over DataFrames of the
    ``Q18_COLUMNS`` of each table: catalog_sales joined with the year's
    dates, the women of unknown education (``cd1``), the customers born
    in the six months, their current demographics (``cd2``, the second
    copy of customer_demographics, its key renamed: a selection), the
    seven states' addresses and item; then seven averages of casts to
    double by ``ROLLUP(i_item_id, ca_country, ca_state, ca_county)``
    (an Expand of five grouping sets, concatenated by K7c, then K9 on the
    four keys and the grouping id), ordered by country, state, county
    and item id (ascending, nulls first).  Returns ``(result, parts)``
    (``joined``, ``agg``, ``sorted``).  ``limit=None`` drops the
    limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.cast import Cast
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo, In
    dt = date_dim.filter(EqualTo(col("d_year"), lit(year))) \
        .select(Alias(col("d_date_sk"), "cs_sold_date_sk"))
    cd1 = (customer_demographics
           .filter(EqualTo(col("cd_gender"), lit("F")))
           .filter(EqualTo(col("cd_education_status"), lit("Unknown")))
           .select(Alias(col("cd_demo_sk"), "cs_bill_cdemo_sk"),
                   col("cd_dep_count")))
    cu = customer.filter(In(col("c_birth_month"), list(Q18_MONTHS))) \
        .select(Alias(col("c_customer_sk"), "cs_bill_customer_sk"),
                col("c_current_cdemo_sk"), col("c_current_addr_sk"),
                col("c_birth_year"))
    cd2 = customer_demographics.select(Alias(col("cd_demo_sk"),
                                             "c_current_cdemo_sk"))
    ca = customer_address.filter(In(col("ca_state"), list(Q18_STATES))) \
        .select(Alias(col("ca_address_sk"), "c_current_addr_sk"),
                col("ca_country"), col("ca_state"), col("ca_county"))
    it = item.select(Alias(col("i_item_sk"), "cs_item_sk"), col("i_item_id"))
    joined = (catalog_sales.join(dt, on="cs_sold_date_sk")
              .join(cd1, on="cs_bill_cdemo_sk")
              .join(cu, on="cs_bill_customer_sk")
              .join(cd2, on="c_current_cdemo_sk")
              .join(ca, on="c_current_addr_sk")
              .join(it, on="cs_item_sk"))
    agg = joined.rollup(*Q18_KEYS).agg(
        *[F.avg(Cast(col(c), T.DOUBLE)).alias(name)
          for name, c in Q18_AVERAGES])
    ordered = agg.order_by(*Q18_ORDER)
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"joined": joined, "agg": agg, "sorted": ordered}


def q18_numpy(tables: Dict[str, dict], year=1998, limit=100) -> list:
    """TPC-DS q18 in numpy over ``q18_tables`` output: the rows as
    dicts, the rollup's rows with None for the keys a level drops."""
    cs, cd = tables["catalog_sales"], tables["customer_demographics"]
    c, ca = tables["customer"], tables["customer_address"]
    d, i = tables["date_dim"], tables["item"]
    rows = np.nonzero(np.isin(cs["cs_sold_date_sk"],
                              d["d_date_sk"][d["d_year"] == year]))[0]
    women = (cd["cd_gender"] == "F") & \
        (cd["cd_education_status"] == "Unknown")
    found, cd1_at = _lookup(cd["cd_demo_sk"][women],
                            cs["cs_bill_cdemo_sk"][rows])
    rows, cd1_at = rows[found], np.nonzero(women)[0][cd1_at[found]]
    born = np.isin(c["c_birth_month"], Q18_MONTHS)
    found, c_at = _lookup(c["c_customer_sk"][born],
                          cs["cs_bill_customer_sk"][rows])
    rows, cd1_at = rows[found], cd1_at[found]
    c_at = np.nonzero(born)[0][c_at[found]]
    keep = np.isin(c["c_current_cdemo_sk"][c_at], cd["cd_demo_sk"])
    rows, cd1_at, c_at = rows[keep], cd1_at[keep], c_at[keep]
    states = np.isin(ca["ca_state"], Q18_STATES)
    found, ca_at = _lookup(ca["ca_address_sk"][states],
                           c["c_current_addr_sk"][c_at])
    rows, cd1_at, c_at = rows[found], cd1_at[found], c_at[found]
    ca_at = np.nonzero(states)[0][ca_at[found]]
    found, i_at = _lookup(i["i_item_sk"], cs["cs_item_sk"][rows])
    rows, cd1_at, c_at, ca_at, i_at = (rows[found], cd1_at[found],
                                       c_at[found], ca_at[found],
                                       i_at[found])
    keys = {"i_item_id": i["i_item_id"][i_at],
            "ca_country": ca["ca_country"][ca_at],
            "ca_state": ca["ca_state"][ca_at],
            "ca_county": ca["ca_county"][ca_at]}
    values = {"cs_quantity": cs["cs_quantity"][rows],
              "cs_list_price": cs["cs_list_price"][rows],
              "cs_coupon_amt": cs["cs_coupon_amt"][rows],
              "cs_sales_price": cs["cs_sales_price"][rows],
              "cs_net_profit": cs["cs_net_profit"][rows],
              "c_birth_year": c["c_birth_year"][c_at],
              "cd_dep_count": cd["cd_dep_count"][cd1_at]}
    out = []
    if not len(rows):
        return out   # the grouping sets of no row give no row, () too
    for level in range(len(Q18_KEYS), -1, -1):
        grouped = Q18_KEYS[:level]
        if level:
            gid, first = _group_ids(*[keys[k] for k in grouped])
            g = len(first)
        else:
            gid, first, g = np.zeros(len(rows), np.int64), [0], 1
        n = np.bincount(gid, minlength=g)
        avgs = {name: np.bincount(gid, weights=values[col_].astype(
            np.float64), minlength=g) / np.maximum(n, 1)
            for name, col_ in Q18_AVERAGES}
        for k in range(g):
            row = {key: (keys[key][first[k]] if key in grouped else None)
                   for key in Q18_KEYS}
            for name, _c in Q18_AVERAGES:
                row[name] = float(avgs[name][k]) if n[k] else None
            out.append(row)

    def order(r):
        return tuple((0, "") if r[k] is None else (1, r[k])
                     for k in Q18_ORDER)
    out.sort(key=order)
    return out if limit is None else out[:limit]


#: the columns of each table that TPC-DS q6 reads
Q6_COLUMNS = {
    "customer_address": ["ca_address_sk", "ca_state"],
    "customer": ["c_customer_sk", "c_current_addr_sk"],
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk"],
    "date_dim": ["d_date_sk", "d_month_seq", "d_year", "d_moy"],
    "item": ["i_item_sk", "i_current_price", "i_category"],
}


def q6_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q6 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q6_COLUMNS.items()}


def q6(customer_address, customer, store_sales, date_dim, item, year=2001,
       moy=1, limit=100):
    """TPC-DS q6 through the port's DataFrame API, over DataFrames of the
    ``Q6_COLUMNS`` of each table.  The JAX plan (``sql/analyzer.py
    _scalar_subquery``, ``:1174-1228``) runs the uncorrelated subquery
    ``select distinct d_month_seq ... where d_year = 2001 and d_moy = 1``
    eagerly and inlines it as a literal (here ``DataFrame.scalar()``:
    1212), and decorrelates ``avg(j.i_current_price)`` by category into a
    keyed average over item, left outer joined on the string key
    ``i_category`` (K10 with a string key: the ten categories build, the
    joined facts probe).  It joins address, customer, store_sales,
    date_dim and item, and then filters ``d_month_seq = 1212 and
    i_current_price > 1.2 * avg`` over the joins; here the month filter
    is applied to date_dim before the joins (the same rows: an inner
    join's conjunct on one side's column), and the joins run from
    store_sales outwards (inner joins, so the same pairs).  Then a count
    by ``ca_state``, ``HAVING count(*) >= 10`` (K5 over the groups) and
    ``ORDER BY cnt, state``.  Returns ``(result, parts)`` (``month``,
    ``joined``, ``agg``)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.arithmetic import Multiply
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, EqualTo, GreaterThan, GreaterThanOrEqual)
    month = (date_dim.filter(And(EqualTo(col("d_year"), lit(year)),
                                 EqualTo(col("d_moy"), lit(moy))))
             .select(col("d_month_seq")).distinct().scalar())
    dt = date_dim.filter(EqualTo(col("d_month_seq"), lit(month))) \
        .select(Alias(col("d_date_sk"), "ss_sold_date_sk"))
    c = customer.select(Alias(col("c_customer_sk"), "ss_customer_sk"),
                        col("c_current_addr_sk"))
    ca = customer_address.select(Alias(col("ca_address_sk"),
                                       "c_current_addr_sk"), col("ca_state"))
    it = item.select(Alias(col("i_item_sk"), "ss_item_sk"),
                     col("i_current_price"), col("i_category"))
    by_category = item.group_by("i_category").agg(
        F.avg("i_current_price").alias("_sval"))
    joined = (store_sales.join(dt, on="ss_sold_date_sk")
              .join(c, on="ss_customer_sk")
              .join(ca, on="c_current_addr_sk")
              .join(it, on="ss_item_sk")
              .join(by_category, on="i_category", how="left"))
    kept = joined.filter(GreaterThan(col("i_current_price"),
                                     Multiply(lit(1.2), col("_sval"))))
    agg = (kept.group_by("ca_state").agg(F.count().alias("cnt"))
           .filter(GreaterThanOrEqual(col("cnt"), lit(10))))
    ordered = agg.select(Alias(col("ca_state"), "state"), col("cnt")) \
        .order_by("cnt", "state")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"month": month, "joined": joined, "agg": agg}


def q6_numpy(tables: Dict[str, dict], year=2001, moy=1, limit=100) -> list:
    """TPC-DS q6 in numpy over ``q6_tables`` output: the rows as dicts."""
    ca, c = tables["customer_address"], tables["customer"]
    ss, d, i = tables["store_sales"], tables["date_dim"], tables["item"]
    months = np.unique(d["d_month_seq"][(d["d_year"] == year) &
                                        (d["d_moy"] == moy)])
    if not len(months):
        return []
    dates = d["d_date_sk"][d["d_month_seq"] == months[0]]
    rows = np.nonzero(np.isin(ss["ss_sold_date_sk"], dates))[0]
    found, c_at = _lookup(c["c_customer_sk"], ss["ss_customer_sk"][rows])
    rows, c_at = rows[found], c_at[found]
    found, ca_at = _lookup(ca["ca_address_sk"], c["c_current_addr_sk"][c_at])
    rows, ca_at = rows[found], ca_at[found]
    found, i_at = _lookup(i["i_item_sk"], ss["ss_item_sk"][rows])
    ca_at, i_at = ca_at[found], i_at[found]
    cats, cat_of = np.unique(i["i_category"], return_inverse=True)
    cat_of = cat_of.ravel()
    price = i["i_current_price"].astype(np.float64)
    avg = np.bincount(cat_of, weights=price, minlength=len(cats)) / \
        np.maximum(np.bincount(cat_of, minlength=len(cats)), 1)
    keep = price[i_at] > 1.2 * avg[cat_of[i_at]]
    states, cnt = np.unique(ca["ca_state"][ca_at[keep]], return_counts=True)
    out = [{"state": s, "cnt": int(n)} for s, n in zip(states.tolist(),
                                                        cnt.tolist())
           if n >= 10]
    out.sort(key=lambda r: (r["cnt"], r["state"]))
    return out if limit is None else out[:limit]


#: the columns of store_sales that TPC-DS q28 reads
Q28_COLUMNS = {
    "store_sales": ["ss_quantity", "ss_list_price", "ss_coupon_amt",
                    "ss_wholesale_cost"],
}
#: q28's six buckets: the quantity range, then the low ends of the
#: list price (+ 10), coupon amount (+ 1000) and wholesale cost (+ 20)
#: ranges
Q28_BUCKETS = ((0, 5, 8, 459, 57), (6, 10, 90, 2323, 31),
               (11, 15, 142, 12214, 79), (16, 20, 135, 6071, 38),
               (21, 25, 122, 836, 17), (26, 30, 154, 7326, 25))


def q28_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q28 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q28_COLUMNS.items()}


def _q28_bounds(bucket):
    """The BETWEEN ranges of one bucket: (column, low, high)."""
    qlo, qhi, lp, ca, wc = bucket
    return (("ss_quantity", qlo, qhi),
            (("ss_list_price", float(lp), float(lp + 10)),
             ("ss_coupon_amt", float(ca), float(ca + 1000)),
             ("ss_wholesale_cost", float(wc), float(wc + 20))))


def q28(store_sales, limit=100):
    """TPC-DS q28 through the port's DataFrame API, over a DataFrame of
    ``Q28_COLUMNS``: six global aggregates of store_sales, each of
    ``avg``, ``count`` and ``count(DISTINCT)`` of ``ss_list_price`` over a
    quantity range and an ``OR`` of three ``BETWEEN`` ranges (K5 for the
    filters, then K1 and K3 beside the global K15d, as q16 runs them),
    cross-joined left-deep as the JAX plan's
    ``BroadcastNestedLoopJoinExec[cross]`` chain (K10x and K7 for each of
    the five joins of one-row sides).  Returns ``(result, parts)``
    (``buckets``)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, GreaterThanOrEqual, LessThanOrEqual, Or)

    def between(name, lo, hi):
        return And(GreaterThanOrEqual(col(name), lit(lo)),
                   LessThanOrEqual(col(name), lit(hi)))
    buckets = []
    for j, bucket in enumerate(Q28_BUCKETS, 1):
        quantity, ranges = _q28_bounds(bucket)
        any_range = between(*ranges[0])
        for r in ranges[1:]:
            any_range = Or(any_range, between(*r))
        buckets.append(
            store_sales.filter(between(*quantity)).filter(any_range)
            .agg(F.avg("ss_list_price").alias(f"b{j}_lp"),
                 F.count("ss_list_price").alias(f"b{j}_cnt"),
                 F.count_distinct("ss_list_price").alias(f"b{j}_cntd")))
    out = buckets[0]
    for b in buckets[1:]:
        out = out.join(b, how="cross")
    return (out if limit is None else out.limit(limit)), \
        {"buckets": buckets}


def q28_numpy(tables: Dict[str, dict], limit=100) -> list:
    """TPC-DS q28 in numpy over ``q28_tables`` output: its one row."""
    ss = tables["store_sales"]
    row = {}
    for j, bucket in enumerate(Q28_BUCKETS, 1):
        (qc, qlo, qhi), ranges = _q28_bounds(bucket)
        sel = (ss[qc] >= qlo) & (ss[qc] <= qhi)
        any_range = np.zeros(len(sel), bool)
        for name, lo, hi in ranges:
            any_range |= (ss[name] >= lo) & (ss[name] <= hi)
        price = ss["ss_list_price"][sel & any_range].astype(np.float64)
        row[f"b{j}_lp"] = float(price.sum() / len(price)) if len(price) \
            else None
        row[f"b{j}_cnt"] = int(len(price))
        row[f"b{j}_cntd"] = int(len(np.unique(price)))
    return [row][:limit]


#: the columns of each table that TPC-DS q36 reads
Q36_COLUMNS = {
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                    "ss_net_profit", "ss_ext_sales_price"],
    "date_dim": ["d_date_sk", "d_year"],
    "item": ["i_item_sk", "i_category", "i_class"],
    "store": ["s_store_sk", "s_state"],
}


def q36_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q36 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q36_COLUMNS.items()}


def q36(store_sales, date_dim, item, store, year=2001, state="TN",
        limit=100):
    """TPC-DS q36 through the port's DataFrame API, over DataFrames of the
    ``Q36_COLUMNS`` of each table, as the JAX plan runs it: store_sales
    joined with the year's dates, item and the state's stores; two sums
    by ``ROLLUP(i_category, i_class)`` (an Expand of three grouping sets,
    K7c, K9 on the keys and the grouping id), with ``lochierarchy =
    grouping(i_category) + grouping(i_class)`` and ``grouping(i_class)``
    computed from the grouping id by K6 (``(gid div 2) % 2 + (gid div 1)
    % 2``; the JAX plan computes them inside its window and projection
    from the grouping id it keeps); then ``rank() OVER (PARTITION BY
    lochierarchy, CASE WHEN grouping(i_class) = 0 THEN i_category END
    ORDER BY sum(ss_net_profit) / sum(ss_ext_sales_price))`` (K6 for the
    CASE, a string view, and the ratio; K8, K7 and K14's ranking pass),
    ``gross_margin`` (K6) and ``ORDER BY lochierarchy DESC, CASE WHEN
    lochierarchy = 0 THEN i_category END, rank_within_parent`` (K6 for
    the CASE key, K8, K7).  Returns ``(result, parts)`` (``joined``,
    ``agg``, ``ranked``)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.arithmetic import Add, Divide
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo
    dt = date_dim.filter(EqualTo(col("d_year"), lit(year))) \
        .select(Alias(col("d_date_sk"), "ss_sold_date_sk"))
    it = item.select(Alias(col("i_item_sk"), "ss_item_sk"),
                     col("i_category"), col("i_class"))
    st = store.filter(EqualTo(col("s_state"), lit(state))) \
        .select(Alias(col("s_store_sk"), "ss_store_sk"))
    joined = (store_sales.join(dt, on="ss_sold_date_sk")
              .join(it, on="ss_item_sk")
              .join(st, on="ss_store_sk"))
    agg = joined.rollup("i_category", "i_class").agg(
        F.sum("ss_net_profit").alias("sum_net_profit"),
        F.sum("ss_ext_sales_price").alias("sum_sales"),
        Add(F.grouping("i_category"),
            F.grouping("i_class")).alias("lochierarchy"),
        F.grouping("i_class").alias("g_class"))
    margin = Divide(col("sum_net_profit"), col("sum_sales"))
    parent = F.Window.partition_by(
        col("lochierarchy"),
        F.when(EqualTo(col("g_class"), lit(0)), col("i_category"))
    ).order_by(F.asc(margin))
    ranked = agg.select(Alias(margin, "gross_margin"), col("i_category"),
                        col("i_class"), col("lochierarchy"),
                        F.rank().over(parent).alias("rank_within_parent"))
    ordered = ranked.order_by(
        F.desc("lochierarchy"),
        F.asc(F.when(EqualTo(col("lochierarchy"), lit(0)),
                     col("i_category"))),
        F.asc("rank_within_parent"))
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"joined": joined, "agg": agg, "ranked": ranked}


def q36_numpy(tables: Dict[str, dict], year=2001, state="TN",
              limit=100) -> list:
    """TPC-DS q36 in numpy over ``q36_tables`` output: the rows as
    dicts."""
    ss, d = tables["store_sales"], tables["date_dim"]
    i, s = tables["item"], tables["store"]
    rows = np.nonzero(np.isin(ss["ss_sold_date_sk"],
                              d["d_date_sk"][d["d_year"] == year]) &
                      np.isin(ss["ss_store_sk"],
                              s["s_store_sk"][s["s_state"] == state]))[0]
    found, i_at = _lookup(i["i_item_sk"], ss["ss_item_sk"][rows])
    rows, i_at = rows[found], i_at[found]
    keys = (i["i_category"][i_at], i["i_class"][i_at])
    profit = ss["ss_net_profit"][rows].astype(np.float64)
    sales = ss["ss_ext_sales_price"][rows].astype(np.float64)
    groups = []     # (category or None, class or None, lochierarchy, sums)
    if len(rows):
        for level in (2, 1, 0):
            if level:
                gid, first = _group_ids(*keys[:level])
                g = len(first)
            else:
                gid, first, g = np.zeros(len(rows), np.int64), [0], 1
            p = np.bincount(gid, weights=profit, minlength=g)
            t = np.bincount(gid, weights=sales, minlength=g)
            for k in range(g):
                groups.append((keys[0][first[k]] if level else None,
                               keys[1][first[k]] if level == 2 else None,
                               2 - level, p[k], t[k]))
    out = []
    parents = {}
    for cat, cls, loc, p, t in groups:
        margin = float(p / t) if t != 0 else None
        parent = (loc, cat if cls is not None else None)
        parents.setdefault(parent, []).append(margin)
        out.append({"gross_margin": margin, "i_category": cat,
                    "i_class": cls, "lochierarchy": loc,
                    "rank_within_parent": None})
    for r in out:
        peers = parents[(r["lochierarchy"], r["i_category"]
                         if r["i_class"] is not None else None)]
        m = r["gross_margin"]
        # nulls first; rank = 1 + the rows strictly before the row
        r["rank_within_parent"] = 1 + sum(
            1 for x in peers if m is not None and
            (x is None or x < m))

    def order(r):
        case = r["i_category"] if r["lochierarchy"] == 0 else None
        return (-r["lochierarchy"], (0, "") if case is None else (1, case),
                r["rank_within_parent"])
    out.sort(key=order)
    return out if limit is None else out[:limit]


#: TPC-DS q51 as the specification writes it (the text the JAX package's
#: ``sql`` runs; ``tests/test_torch_tpcds_q51.py`` holds the recipe
#: against it)
Q51_SQL = """
WITH web_v1 as (
select
  ws_item_sk item_sk, d_date,
  sum(sum(ws_sales_price))
      over (partition by ws_item_sk order by d_date rows between unbounded preceding and current row) cume_sales
from web_sales
    ,date_dim
where ws_sold_date_sk=d_date_sk
  and d_month_seq between 1200 and 1200+11
  and ws_item_sk is not NULL
group by ws_item_sk, d_date),
store_v1 as (
select
  ss_item_sk item_sk, d_date,
  sum(sum(ss_sales_price))
      over (partition by ss_item_sk order by d_date rows between unbounded preceding and current row) cume_sales
from store_sales
    ,date_dim
where ss_sold_date_sk=d_date_sk
  and d_month_seq between 1200 and 1200+11
  and ss_item_sk is not NULL
group by ss_item_sk, d_date)
 select  *
from (select item_sk
     ,d_date
     ,web_sales
     ,store_sales
     ,max(web_sales)
         over (partition by item_sk order by d_date rows between unbounded preceding and current row) web_cumulative
     ,max(store_sales)
         over (partition by item_sk order by d_date rows between unbounded preceding and current row) store_cumulative
     from (select case when web.item_sk is not null then web.item_sk else store.item_sk end item_sk
                 ,case when web.d_date is not null then web.d_date else store.d_date end d_date
                 ,web.cume_sales web_sales
                 ,store.cume_sales store_sales
           from web_v1 web full outer join store_v1 store on (web.item_sk = store.item_sk
                                                          and web.d_date = store.d_date)
          )x )y
where web_cumulative > store_cumulative
order by item_sk
        ,d_date
limit 100
"""

#: the columns of each table that TPC-DS q51 reads
Q51_COLUMNS = {
    "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_sales_price"],
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_sales_price"],
    "date_dim": ["d_date_sk", "d_date", "d_month_seq"],
}


def q51_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q51 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q51_COLUMNS.items()}


def q51(web_sales, store_sales, date_dim, month_seq=1200, limit=100):
    """TPC-DS q51 through the port's DataFrame API, over DataFrames of the
    ``Q51_COLUMNS`` of each table, as ``Q51_SQL`` reads: for web and store
    sales (``web_v1``, ``store_v1``) the year's dates joined in, ``item_sk
    IS NOT NULL`` (K5), the sum by (item, date) (K9), and its running sum
    by item over the dates, ``ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT
    ROW`` (K8, K7, **K14s**); then the **full outer join** of the two on
    (item, date) (**K10f**, K7), ``CASE WHEN web.x IS NOT NULL THEN web.x
    ELSE store.x END`` for the item (an int) and the date (K6), the two
    running ``max`` windows over the nullable cumulative sums (one K14s
    call), ``web_cumulative > store_cumulative`` (K5) and ``ORDER BY
    item_sk, d_date LIMIT 100`` (K8, K7).  Returns ``(result, parts)``
    (``web``, ``store``, ``joined``, ``windowed``)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, GreaterThan, GreaterThanOrEqual, IsNotNull, LessThanOrEqual)
    running = (F.Window.unboundedPreceding, F.Window.currentRow)
    dates = date_dim.filter(And(
        GreaterThanOrEqual(col("d_month_seq"), lit(month_seq)),
        LessThanOrEqual(col("d_month_seq"), lit(month_seq + 11))))

    def cumulative(sales, p, name):
        dt = dates.select(Alias(col("d_date_sk"), f"{p}_sold_date_sk"),
                          col("d_date"))
        by_day = (sales.filter(IsNotNull(col(f"{p}_item_sk")))
                  .join(dt, on=f"{p}_sold_date_sk")
                  .group_by(f"{p}_item_sk", "d_date")
                  .agg(F.sum(f"{p}_sales_price").alias("_day_sales")))
        w = F.Window.partition_by(f"{p}_item_sk").order_by("d_date") \
            .rows_between(*running)
        return by_day.select(
            Alias(col(f"{p}_item_sk"), f"{name}_item_sk"),
            Alias(col("d_date"), f"{name}_d_date"),
            F.sum("_day_sales").over(w).alias(f"{name}_cume"))
    web = cumulative(web_sales, "ws", "web")
    store = cumulative(store_sales, "ss", "store")
    joined = web.join(store, on=[("web_item_sk", "store_item_sk"),
                                 ("web_d_date", "store_d_date")],
                      how="full")

    def either(c):
        return F.when(IsNotNull(col(f"web_{c}")), col(f"web_{c}")) \
            .otherwise(col(f"store_{c}")).alias(c)
    x = joined.select(either("item_sk"), either("d_date"),
                      Alias(col("web_cume"), "web_sales"),
                      Alias(col("store_cume"), "store_sales"))
    w = F.Window.partition_by("item_sk").order_by("d_date") \
        .rows_between(*running)
    windowed = x.select(col("item_sk"), col("d_date"), col("web_sales"),
                        col("store_sales"),
                        F.max("web_sales").over(w).alias("web_cumulative"),
                        F.max("store_sales").over(w)
                        .alias("store_cumulative"))
    ordered = windowed.filter(GreaterThan(col("web_cumulative"),
                                          col("store_cumulative"))) \
        .order_by("item_sk", "d_date")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"web": web, "store": store, "joined": joined,
                 "windowed": windowed}


def q51_numpy(tables: Dict[str, dict], month_seq=1200, limit=100) -> list:
    """TPC-DS q51 in numpy over ``q51_tables`` output: the rows as dicts.
    Items are walked in order, each one's days in order (the query's sort
    order), so a limit stops the walk early."""
    d = tables["date_dim"]
    keep = (d["d_month_seq"] >= month_seq) & \
        (d["d_month_seq"] <= month_seq + 11)
    day_of = dict(zip(d["d_date_sk"][keep].tolist(),
                      d["d_date"][keep].astype("datetime64[D]")
                      .astype(np.int64).tolist()))
    sk = np.fromiter(day_of, np.int64)
    day = np.fromiter(day_of.values(), np.int64)
    days = int(day.max() - day.min() + 1) if len(day) else 1
    first_day = int(day.min()) if len(day) else 0

    def by_day(p):
        """(sorted (item, day) codes, their sums) of one sales table."""
        s = tables["web_sales" if p == "ws" else "store_sales"]
        date_sk, item = s[f"{p}_sold_date_sk"], s[f"{p}_item_sk"]
        found = np.isin(date_sk, sk)
        order = np.argsort(sk)
        at = order[np.searchsorted(sk[order], date_sk[found])]
        codes = item[found].astype(np.int64) * days + (day[at] - first_day)
        uniq, inv = np.unique(codes, return_inverse=True)
        return uniq, np.bincount(inv.ravel(), weights=s[f"{p}_sales_price"]
                                 [found].astype(np.float64),
                                 minlength=len(uniq))
    web, store = by_day("ws"), by_day("ss")
    keys = np.union1d(web[0], store[0])
    items = keys // days
    starts = np.r_[0, np.nonzero(np.diff(items))[0] + 1, len(keys)]
    out = []
    for a, b in zip(starts[:-1], starts[1:]):
        codes = keys[a:b]
        cols = []
        for codes_t, sums in (web, store):
            lo, hi = np.searchsorted(codes_t, [codes[0], codes[-1] + 1])
            cume = dict(zip(codes_t[lo:hi].tolist(),
                            np.cumsum(sums[lo:hi]).tolist()))
            cols.append([cume.get(c) for c in codes.tolist()])
        best = [None, None]
        for j, c in enumerate(codes.tolist()):
            pair = [cols[0][j], cols[1][j]]
            best = [v if m is None or (v is not None and v > m) else m
                    for m, v in zip(best, pair)]
            if best[0] is not None and best[1] is not None and \
                    best[0] > best[1]:
                out.append({
                    "item_sk": c // days,
                    "d_date": (np.datetime64(first_day + c % days, "D")
                               .astype(datetime.date)),
                    "web_sales": pair[0], "store_sales": pair[1],
                    "web_cumulative": best[0],
                    "store_cumulative": best[1]})
        if limit is not None and len(out) >= limit:
            break
    return out if limit is None else out[:limit]


#: the columns of each table that ``q51w`` reads (q51's store half)
Q51W_COLUMNS = {
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_sales_price"],
    "date_dim": ["d_date_sk", "d_date", "d_month_seq"],
}


def q51w_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The ``q51w`` columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q51W_COLUMNS.items()}


def q51w(store_sales, date_dim, month_seq=1200, limit=100):
    """q51's ``store_v1`` (each item's sales by day over the year's 12
    months, unique by item and day) with the bounded and offset window
    kinds q51 itself does not run, by item over the days: the 7-day
    moving average (``avg`` over ``ROWS BETWEEN 6 PRECEDING AND CURRENT
    ROW``: K14b), the day before's sales (``lag(x, 1, 0.0)``: K14o's
    source rows, K7, K14o's default), the next day's (``lead(x)``) and the
    item's quartile of days (``ntile(4)``: K14o), then the sums of the
    moving averages, of the days before and of the quartiles, and the
    counts of next days and of days, over every row (K1 and K3: a
    group-by of the four quartiles would fold each on one K9 thread).
    Returns ``(result, parts)`` (``by_day``, ``windowed``)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, GreaterThanOrEqual, IsNotNull, LessThanOrEqual)
    dt = date_dim.filter(And(
        GreaterThanOrEqual(col("d_month_seq"), lit(month_seq)),
        LessThanOrEqual(col("d_month_seq"), lit(month_seq + 11)))) \
        .select(Alias(col("d_date_sk"), "ss_sold_date_sk"), col("d_date"))
    by_day = (store_sales.filter(IsNotNull(col("ss_item_sk")))
              .join(dt, on="ss_sold_date_sk")
              .group_by("ss_item_sk", "d_date")
              .agg(F.sum("ss_sales_price").alias("sales")))
    w = F.Window.partition_by("ss_item_sk").order_by("d_date")
    windowed = by_day.select(
        col("ss_item_sk"), col("d_date"), col("sales"),
        F.avg("sales").over(w.rows_between(-6, 0)).alias("ma7"),
        F.lag("sales", 1, 0.0).over(w).alias("before"),
        F.lead("sales", 1).over(w).alias("after"),
        F.ntile(4).over(w).alias("quartile"))
    out = windowed.agg(F.sum("ma7").alias("sum_ma7"),
                       F.sum("before").alias("sum_before"),
                       F.sum("quartile").alias("sum_quartile"),
                       F.count("after").alias("next_days"),
                       F.count().alias("days"))
    return (out if limit is None else out.limit(limit)), \
        {"by_day": by_day, "windowed": windowed}


def q51w_numpy(tables: Dict[str, dict], month_seq=1200, limit=100) -> list:
    """``q51w`` in numpy over ``q51w_tables`` output: the rows as dicts."""
    d, s = tables["date_dim"], tables["store_sales"]
    keep = (d["d_month_seq"] >= month_seq) & \
        (d["d_month_seq"] <= month_seq + 11)
    sk = d["d_date_sk"][keep]
    day = d["d_date"][keep].astype("datetime64[D]").astype(np.int64)
    found = np.isin(s["ss_sold_date_sk"], sk)
    order = np.argsort(sk)
    at = order[np.searchsorted(sk[order], s["ss_sold_date_sk"][found])]
    span = int(day.max() - day.min() + 1) if len(day) else 1
    codes = s["ss_item_sk"][found].astype(np.int64) * span + \
        (day[at] - (day.min() if len(day) else 0))
    uniq, inv = np.unique(codes, return_inverse=True)
    sales = np.bincount(inv.ravel(), weights=s["ss_sales_price"][found]
                        .astype(np.float64), minlength=len(uniq))
    n = len(uniq)
    item = uniq // span
    pos = np.arange(n)
    start = np.r_[True, item[1:] != item[:-1]] if n else np.zeros(0, bool)
    pstart = np.maximum.accumulate(np.where(start, pos, 0)) if n else pos
    last = np.r_[item[1:] != item[:-1], True] if n else np.zeros(0, bool)
    pend = np.minimum.accumulate(np.where(last, pos, n)[::-1])[::-1] \
        if n else pos
    total, count = np.zeros(n), np.zeros(n)
    for k in range(7):
        ok = pos - k >= pstart
        total += np.where(ok, sales[np.maximum(pos - k, 0)], 0.0)
        count += ok
    ma7 = total / count
    before = np.where(pos - 1 >= pstart, sales[np.maximum(pos - 1, 0)], 0.0)
    has_after = pos + 1 <= pend
    size, within = pend - pstart + 1, pos - pstart
    base, rem = size // 4, size % 4
    big = rem * (base + 1)
    quartile = np.where(within < big, within // np.maximum(base + 1, 1),
                        rem + (within - big) // np.maximum(base, 1)) + 1
    out = [{"sum_ma7": float(ma7.sum()) if n else None,
            "sum_before": float(before.sum()) if n else None,
            "sum_quartile": int(quartile.sum()) if n else None,
            "next_days": int(has_after.sum()), "days": n}]
    return out if limit is None else out[:limit]


#: the columns of each table that TPC-DS q8 reads
Q8_COLUMNS = {
    "store_sales": ["ss_sold_date_sk", "ss_store_sk", "ss_net_profit"],
    "date_dim": ["d_date_sk", "d_year", "d_qoy"],
    "store": ["s_store_sk", "s_store_name", "s_zip"],
    "customer_address": ["ca_address_sk", "ca_zip"],
    "customer": ["c_current_addr_sk", "c_preferred_cust_flag"],
}
#: q8's IN list of zips, as the query writes it (128 literals, '19849'
#: twice)
Q8_ZIPS = (
    "24128", "76232", "65084", "87816", "83926", "77556", "20548", "26231",
    "43848", "15126", "91137", "61265", "98294", "25782", "17920", "18426",
    "98235", "40081", "84093", "28577", "55565", "17183", "54601", "67897",
    "22752", "86284", "18376", "38607", "45200", "21756", "29741", "96765",
    "23932", "89360", "29839", "25989", "28898", "91068", "72550", "10390",
    "18845", "47770", "82636", "41367", "76638", "86198", "81312", "37126",
    "39192", "88424", "72175", "81426", "53672", "10445", "42666", "66864",
    "66708", "41248", "48583", "82276", "18842", "78890", "49448", "14089",
    "38122", "34425", "79077", "19849", "43285", "39861", "66162", "77610",
    "13695", "99543", "83444", "83041", "12305", "57665", "68341", "25003",
    "57834", "62878", "49130", "81096", "18840", "27700", "23470", "50412",
    "21195", "16021", "76107", "71954", "68309", "18119", "98359", "64544",
    "10336", "86379", "27068", "39736", "98569", "28915", "24206", "56529",
    "57647", "54917", "42961", "91110", "63981", "14922", "36420", "23006",
    "67467", "32754", "30903", "20260", "31671", "51373", "33998", "71137",
    "30984", "84387", "28246", "18030", "60576", "19849", "40429", "30389")


def q8_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q8 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q8_COLUMNS.items()}


def q8(store_sales, date_dim, store, customer_address, customer,
       year=1998, qoy=2, zips=Q8_ZIPS, limit=100):
    """TPC-DS q8 through the port's DataFrame API, over DataFrames of the
    ``Q8_COLUMNS`` of each table, as the JAX plan runs it:

    - ``v1`` is an INTERSECT (``DataFrame.intersect``: a distinct, then a
      null-safe left semi join on ``ca_zip``) of the addresses' 5-byte zip
      prefixes in the 128-zip list (K5's ``IN`` over a substring view;
      K13 writes ``substr(ca_zip, 1, 5)`` for the survivors; K9 the
      distinct) and the zips of more than two preferred customers (a
      count by ``ca_zip``, the column, as Spark resolves the GROUP BY
      name, then ``substr(ca_zip, 1, 5)`` of each group, K13);
    - store_sales joined with the quarter's dates and the stores, then
      inner joined with ``v1`` on ``substr(s_zip, 1, 2) =
      substr(v1.ca_zip, 1, 2)``: both keys are string columns K13 writes
      (a store meets each v1 zip of its prefix, as the SQL's join does);
    - ``sum(ss_net_profit)`` by ``s_store_name`` (named ``col1``, as the
      JAX analyzer names an unaliased select item), ordered by the name.

    Returns ``(result, parts)`` (``v1``, ``joined``)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, EqualTo, GreaterThan, In)
    zip5 = F.substring("ca_zip", 1, 5)
    listed = customer_address.filter(In(zip5, [lit(z) for z in zips])) \
        .select(Alias(zip5, "ca_zip"))
    preferred = customer.filter(EqualTo(col("c_preferred_cust_flag"),
                                        lit("Y"))) \
        .select(Alias(col("c_current_addr_sk"), "ca_address_sk"))
    crowded = (customer_address.join(preferred, on="ca_address_sk")
               .group_by("ca_zip").agg(F.count().alias("cnt"))
               .filter(GreaterThan(col("cnt"), lit(2)))
               .select(Alias(F.substring("ca_zip", 1, 5), "ca_zip")))
    v1 = listed.intersect(crowded)
    dt = date_dim.filter(And(EqualTo(col("d_qoy"), lit(qoy)),
                             EqualTo(col("d_year"), lit(year)))) \
        .select(Alias(col("d_date_sk"), "ss_sold_date_sk"))
    st = store.select(Alias(col("s_store_sk"), "ss_store_sk"),
                      col("s_store_name"),
                      Alias(F.substring("s_zip", 1, 2), "s_zip2"))
    v1_keys = v1.select(Alias(F.substring("ca_zip", 1, 2), "ca_zip2"))
    joined = (store_sales.join(dt, on="ss_sold_date_sk")
              .join(st, on="ss_store_sk")
              .join(v1_keys, on=[("s_zip2", "ca_zip2")]))
    ordered = joined.group_by("s_store_name").agg(
        F.sum("ss_net_profit").alias("col1")).order_by("s_store_name")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"v1": v1, "joined": joined}


def _utf8_prefix(values, n: int) -> np.ndarray:
    """The first ``n`` bytes of each string (None stays None): the JAX
    device form's byte rule, for the ASCII columns of this generator."""
    return np.array([None if v is None else
                     v.encode("utf-8")[:n].decode("utf-8", "replace")
                     for v in values], dtype=object)


def q8_numpy(tables: Dict[str, dict], year=1998, qoy=2, zips=Q8_ZIPS,
             limit=100) -> list:
    """TPC-DS q8 in numpy over ``q8_tables`` output: the rows as dicts."""
    ss, d, s = tables["store_sales"], tables["date_dim"], tables["store"]
    ca, c = tables["customer_address"], tables["customer"]
    zip5 = _utf8_prefix(ca["ca_zip"], 5)
    listed = set(zip5[np.isin(zip5, np.array(zips, dtype=object))]
                 .tolist())
    addr = c["c_current_addr_sk"][c["c_preferred_cust_flag"] == "Y"]
    found, at = _lookup(ca["ca_address_sk"], addr)
    zips_of, cnt = np.unique(ca["ca_zip"][at[found]].astype(str),
                             return_counts=True)
    crowded = set(_utf8_prefix(zips_of[cnt > 2].tolist(), 5).tolist())
    v1_zip2 = [z.encode("utf-8")[:2] for z in listed & crowded]
    dates = d["d_date_sk"][(d["d_year"] == year) & (d["d_qoy"] == qoy)]
    rows = np.isin(ss["ss_sold_date_sk"], dates)
    found, s_at = _lookup(s["s_store_sk"], ss["ss_store_sk"][rows])
    profit = ss["ss_net_profit"][rows][found]
    s_at = s_at[found]
    # each store row meets every v1 zip of its 2-byte prefix
    times = np.array([sum(z == str(v).encode("utf-8")[:2] for z in v1_zip2)
                      for v in s["s_zip"]], dtype=np.int64)
    names = s["s_store_name"]
    total: Dict[str, float] = {}
    for name, p, k in zip(names[s_at].tolist(), profit.tolist(),
                          times[s_at].tolist()):
        for _ in range(k):
            total[name] = total.get(name, 0.0) + p
    out = [{"s_store_name": n, "col1": v} for n, v in sorted(total.items())]
    return out if limit is None else out[:limit]


#: the columns of each table that TPC-DS q5 reads
Q5_COLUMNS = {
    "store_sales": ["ss_store_sk", "ss_sold_date_sk", "ss_ext_sales_price",
                    "ss_net_profit"],
    "store_returns": ["sr_store_sk", "sr_returned_date_sk",
                      "sr_return_amt", "sr_net_loss"],
    "catalog_sales": ["cs_catalog_page_sk", "cs_sold_date_sk",
                      "cs_ext_sales_price", "cs_net_profit"],
    "catalog_returns": ["cr_catalog_page_sk", "cr_returned_date_sk",
                        "cr_return_amount", "cr_net_loss"],
    "web_sales": ["ws_web_site_sk", "ws_sold_date_sk", "ws_ext_sales_price",
                  "ws_net_profit", "ws_web_page_sk"],
    "web_returns": ["wr_web_page_sk", "wr_returned_date_sk",
                    "wr_return_amt", "wr_net_loss"],
    "date_dim": ["d_date_sk", "d_date"],
    "store": ["s_store_sk", "s_store_id"],
    "catalog_page": ["cp_catalog_page_sk", "cp_catalog_page_id"],
    "web_site": ["web_site_sk", "web_site_id"],
}
#: q5's dates: ``cast('2000-08-23' as date)`` and ``+ interval 14 day``
#: folded to a literal, as Spark's optimizer folds it
Q5_DATES = (datetime.date(2000, 8, 23), datetime.date(2000, 9, 6))
#: q5's channels: (name, the id's literal prefix, the dimension, its key
#: and id columns)
Q5_CHANNELS = (("store channel", "store", "store", "s_store_sk",
                "s_store_id"),
               ("catalog channel", "catalog_page", "catalog_page",
                "cp_catalog_page_sk", "cp_catalog_page_id"),
               ("web channel", "web_site", "web_site", "web_site_sk",
                "web_site_id"))


def q5_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q5 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q5_COLUMNS.items()}


def q5(store_sales, store_returns, catalog_sales, catalog_returns,
       web_sales, web_returns, date_dim, store, catalog_page, web_site,
       dates=Q5_DATES, limit=100):
    """TPC-DS q5 through the port's DataFrame API, over DataFrames of the
    ``Q5_COLUMNS`` of each table, as the JAX plan runs it.  For each
    channel a UNION ALL (``DataFrame.union``, no device work) of its
    sales (returns as 0.0) and its returns (sales as 0.0; the web
    returns left outer joined with web_sales on the page, whose site they
    take: about 1,333 web_sales rows a page at sf 10), joined with the
    dates and the dimension, summed by the dimension's id; then ``'store
    channel' AS channel``, ``'store' || s_store_id AS id`` (K13 writes
    both: a literal and a concat) and ``profit - profit_loss`` (K6); the
    three channels' UNION ALL, ``ROLLUP(channel, id)`` of three sums,
    ordered by channel and id.  The SQL's ``cast('2000-08-23' as date) +
    interval 14 day`` is the folded date literal 2000-09-06, as Spark's
    optimizer folds it (``Q5_DATES``).  A union's partitions are its
    children's, so every join and group-by above one runs behind
    exchanges even when each table is one partition, as in the JAX plan.
    Returns ``(result, parts)`` (``channels``: each channel's sums)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.arithmetic import Subtract
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, GreaterThanOrEqual, LessThanOrEqual)
    lo, hi = dates
    dt = date_dim.filter(And(GreaterThanOrEqual(col("d_date"), lit(lo)),
                             LessThanOrEqual(col("d_date"), lit(hi)))) \
        .select(Alias(col("d_date_sk"), "date_sk"))
    zero = lit(0.0)

    def rows(df, key, date, sales, profit, amt, loss):
        return df.select(
            Alias(col(key), "key_sk"), Alias(col(date), "date_sk"),
            Alias(col(sales) if sales else zero, "sales_price"),
            Alias(col(profit) if profit else zero, "profit"),
            Alias(col(amt) if amt else zero, "return_amt"),
            Alias(col(loss) if loss else zero, "net_loss"))

    web_returns = web_returns.join(
        web_sales.select(col("ws_web_page_sk"), col("ws_web_site_sk")),
        on=[("wr_web_page_sk", "ws_web_page_sk")], how="left")
    pairs = (
        (rows(store_sales, "ss_store_sk", "ss_sold_date_sk",
              "ss_ext_sales_price", "ss_net_profit", None, None),
         rows(store_returns, "sr_store_sk", "sr_returned_date_sk", None,
              None, "sr_return_amt", "sr_net_loss"), store),
        (rows(catalog_sales, "cs_catalog_page_sk", "cs_sold_date_sk",
              "cs_ext_sales_price", "cs_net_profit", None, None),
         rows(catalog_returns, "cr_catalog_page_sk", "cr_returned_date_sk",
              None, None, "cr_return_amount", "cr_net_loss"), catalog_page),
        (rows(web_sales, "ws_web_site_sk", "ws_sold_date_sk",
              "ws_ext_sales_price", "ws_net_profit", None, None),
         rows(web_returns, "ws_web_site_sk", "wr_returned_date_sk", None,
              None, "wr_return_amt", "wr_net_loss"), web_site))
    channels, parts = [], []
    for (sales, returns, dim), (name, prefix, _t, key, ident) in zip(
            pairs, Q5_CHANNELS):
        dim = dim.select(Alias(col(key), "key_sk"), col(ident))
        sums = (sales.union(returns).join(dt, on="date_sk")
                .join(dim, on="key_sk")
                .group_by(ident).agg(
                    F.sum("sales_price").alias("sales"),
                    F.sum("profit").alias("profit"),
                    F.sum("return_amt").alias("returns_amt"),
                    F.sum("net_loss").alias("profit_loss")))
        parts.append(sums)
        channels.append(sums.select(
            Alias(lit(name), "channel"),
            Alias(F.concat(lit(prefix), col(ident)), "id"),
            col("sales"), col("returns_amt"),
            Alias(Subtract(col("profit"), col("profit_loss")), "profit")))
    x = channels[0].union(channels[1]).union(channels[2])
    ordered = x.rollup("channel", "id").agg(
        F.sum("sales").alias("sales"),
        F.sum("returns_amt").alias("returns_amt"),
        F.sum("profit").alias("profit")).order_by("channel", "id")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"channels": parts}


def q5_numpy(tables: Dict[str, dict], dates=Q5_DATES, limit=100) -> list:
    """TPC-DS q5 in numpy over ``q5_tables`` output: the rows as dicts
    (sums in row order, so they match the engines within 1e-6
    relative)."""
    d = tables["date_dim"]
    lo, hi = (np.datetime64(x, "D") for x in dates)
    in_range = d["d_date_sk"][(d["d_date"] >= lo) & (d["d_date"] <= hi)]
    ws, wr = tables["web_sales"], tables["web_returns"]
    # the web returns' left outer join with web_sales on the page (site -1
    # where no web_sales row has the page)
    order = np.argsort(ws["ws_web_page_sk"], kind="stable")
    pages = ws["ws_web_page_sk"][order]
    first = np.searchsorted(pages, wr["wr_web_page_sk"], "left")
    cnt = np.searchsorted(pages, wr["wr_web_page_sk"], "right") - first
    emit = np.maximum(cnt, 1)
    wr_at = np.repeat(np.arange(len(emit)), emit)
    within = np.arange(int(emit.sum())) - np.repeat(np.cumsum(emit) - emit,
                                                     emit)
    at = np.minimum(np.repeat(first, emit) + within, max(len(order) - 1, 0))
    wr_site = np.where(np.repeat(cnt > 0, emit),
                       ws["ws_web_site_sk"][order][at], -1) \
        if len(order) else np.full(len(wr_at), -1)
    facts = (
        (tables["store_sales"], "ss_store_sk", "ss_sold_date_sk",
         "ss_ext_sales_price", "ss_net_profit", None, None),
        (tables["store_returns"], "sr_store_sk", "sr_returned_date_sk",
         None, None, "sr_return_amt", "sr_net_loss"),
        (tables["catalog_sales"], "cs_catalog_page_sk", "cs_sold_date_sk",
         "cs_ext_sales_price", "cs_net_profit", None, None),
        (tables["catalog_returns"], "cr_catalog_page_sk",
         "cr_returned_date_sk", None, None, "cr_return_amount",
         "cr_net_loss"),
        (tables["web_sales"], "ws_web_site_sk", "ws_sold_date_sk",
         "ws_ext_sales_price", "ws_net_profit", None, None),
        ({"key": wr_site,
          "date": wr["wr_returned_date_sk"][wr_at],
          "amt": wr["wr_return_amt"][wr_at],
          "loss": wr["wr_net_loss"][wr_at]}, "key", "date", None, None,
         "amt", "loss"))
    out = []
    for c, (name, prefix, dim_name, key, ident) in enumerate(Q5_CHANNELS):
        dim = tables[dim_name]
        id_of = dict(zip(dim[key].tolist(), dim[ident].tolist()))
        sums: Dict[str, list] = {}
        for t, k, dcol, sales, profit, amt, loss in facts[2 * c:2 * c + 2]:
            n = len(t[k])
            keep = np.isin(t[dcol], in_range)
            cols = [(t[x] if x else np.zeros(n))[keep].tolist()
                    for x in (sales, profit, amt, loss)]
            for i, key_ in enumerate(t[k][keep].tolist()):
                ident_ = id_of.get(key_)
                if ident_ is None:
                    continue
                acc = sums.setdefault(ident_, [0.0] * 4)
                for j in range(4):
                    acc[j] += cols[j][i]
        for ident_, (sa, pr, am, lo_) in sums.items():
            out.append((name, prefix + ident_, sa, am, pr - lo_))
    rows = []
    for level in (2, 1, 0):
        groups: Dict[tuple, list] = {}
        for r in out:
            g = r[:2] if level == 2 else (r[0], None) if level == 1 \
                else (None, None)
            acc = groups.setdefault(g, [0.0] * 3)
            for j in range(3):
                acc[j] += r[2 + j]
        rows += [{"channel": g[0], "id": g[1], "sales": v[0],
                  "returns_amt": v[1], "profit": v[2]}
                 for g, v in groups.items()]
    rows.sort(key=lambda r: (r["channel"] is not None, r["channel"] or "",
                             r["id"] is not None, r["id"] or ""))
    return rows if limit is None else rows[:limit]


#: the version the ``_DONE`` marker of a written table set holds (the JAX
#: package's ``_DATAGEN_VERSION``)
DATAGEN_VERSION = 3


def write_parquet_tables(tables: Dict[str, dict], root: str,
                         num_partitions: int = 1, columns=None) -> str:
    """Writes each table of ``tables`` (``generate_tables`` output) as the
    JAX package's ``_register_tables_parquet`` writes it
    (``spark_rapids_tpu/testing/tpcds.py:437``): a directory a table
    under ``root``, ``part-{i}.parquet`` files cut by the
    ``register_tables`` rule (``num_partitions`` parts of 1000 rows or
    more, else one), pyarrow's default row groups, and a ``_DONE`` marker
    with the generator's version.  ``columns`` ({table: names}, e.g. a
    query's ``Q*_COLUMNS``) writes only those.  Returns ``root``."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(root, exist_ok=True)
    for name, cols in tables.items():
        if columns is not None and name not in columns:
            continue
        keep = cols if columns is None else \
            {c: cols[c] for c in columns[name]}
        tdir = os.path.join(root, name)
        os.makedirs(tdir, exist_ok=True)
        tbl = pa.table({k: pa.array(v) for k, v in keep.items()})
        nrows = tbl.num_rows
        parts = num_partitions if nrows >= 1000 else 1
        per = max(1, (nrows + parts - 1) // parts)
        for i in range(parts):
            piece = tbl.slice(i * per, per)
            if piece.num_rows or i == 0:
                pq.write_table(piece,
                               os.path.join(tdir, f"part-{i}.parquet"))
    with open(os.path.join(root, "_DONE"), "w") as f:
        f.write(str(DATAGEN_VERSION))
    return root


def merge_columns(*column_sets) -> Dict[str, list]:
    """The union of several queries' ``Q*_COLUMNS``, in first-seen
    order (one table set written for all of them)."""
    out: Dict[str, list] = {}
    for cs in column_sets:
        for t, names in cs.items():
            have = out.setdefault(t, [])
            have += [c for c in names if c not in have]
    return out


def parquet_frames(session, root: str, columns: Dict[str, list]) -> list:
    """A DataFrame a table of ``columns`` (a query's ``Q*_COLUMNS``, whose
    order is its recipe's arguments), read from ``root`` (as
    ``write_parquet_tables`` writes it) with ``read.parquet(...,
    columns=)``: the columns the query reads, as the JAX planner prunes
    them."""
    import os
    return [session.read.parquet(os.path.join(root, t), columns=list(cs))
            for t, cs in columns.items()]
