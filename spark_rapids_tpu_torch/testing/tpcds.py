"""TPC-DS tables for the port: a copy of the JAX package's generator
(``spark_rapids_tpu/testing/tpcds.py``: ``_BASE``, ``_money`` and
``generate_tables`` ``:82``), kept here because the port imports nothing of
the JAX package and ``chip_smoke.py`` needs the tables on a machine
without it.  It is host numpy; the same ``sf`` and ``seed`` give the same
arrays as the JAX package's generator, column by column (a test checks).

Row counts scale with ``sf`` from ``_BASE`` (store_sales 30,000 rows per
sf); date_dim and the other small dimensions do not scale.  Money columns
are doubles rounded to cents, as in the JAX package.

``Q3_COLUMNS`` names the columns TPC-DS q3 reads; ``q3_tables`` cuts the
generator's dict down to them (the port has no column pruning and no date
type yet)."""

from __future__ import annotations

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
